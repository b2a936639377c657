"""RTopic / RPatternTopic (reference: `RedissonTopic.java`,
`RedissonPatternTopic.java` — listener registration over the L1 pub/sub
registry; publish returns receiver count)."""

from __future__ import annotations

from typing import Any, Callable, List


class RTopic:
    def __init__(self, name: str, executor, codec, pubsub):
        self.name = name
        self._executor = executor
        self._codec = codec
        self._pubsub = pubsub
        self._listeners: set = set()  # hub listener ids

    def publish(self, message: Any) -> int:
        """Publish; returns the number of receivers (PUBLISH reply)."""
        return self.publish_async(message).result()

    def publish_async(self, message: Any):
        return self._executor.execute_async(
            self.name,
            "publish",
            {"channel": self.name, "message": self._codec.encode(message)},
        )

    def add_listener(self, listener: Callable[[str, Any], None]) -> int:
        """listener(channel, decoded_message); returns a removable id."""

        def wrapped(channel: str, raw):
            listener(channel, self._codec.decode(raw))

        hub_id = self._pubsub.subscribe(self.name, wrapped)
        self._listeners.add(hub_id)
        return hub_id

    def remove_listener(self, listener_id: int) -> None:
        self._listeners.discard(listener_id)
        self._pubsub.unsubscribe(self.name, listener_id)

    def get_channel_names(self) -> List[str]:
        """Reference getChannelNames() (one channel per topic here)."""
        return [self.name]

    def remove_all_listeners(self) -> None:
        for lid in list(self._listeners):
            self.remove_listener(lid)


class RPatternTopic:
    """Glob-pattern subscription (PSUBSCRIBE semantics)."""

    def __init__(self, pattern: str, executor, codec, pubsub):
        self.pattern = pattern
        self._executor = executor
        self._codec = codec
        self._pubsub = pubsub
        self._listeners: set = set()

    def add_listener(self, listener: Callable[[str, str, Any], None]) -> int:
        """listener(pattern, channel, decoded_message)."""

        def wrapped(pattern: str, channel: str, raw):
            listener(pattern, channel, self._codec.decode(raw))

        hub_id = self._pubsub.psubscribe(self.pattern, wrapped)
        self._listeners.add(hub_id)
        return hub_id

    def get_pattern_names(self) -> List[str]:
        """Reference getPatternNames()."""
        return [self.pattern]

    def remove_listener(self, listener_id: int) -> None:
        self._listeners.discard(listener_id)
        self._pubsub.punsubscribe(self.pattern, listener_id)

    def remove_all_listeners(self) -> None:
        for lid in list(self._listeners):
            self.remove_listener(lid)
