"""Double-buffered host->device staging pipeline (counterpart of
`redisson_tpu.ingest.pipeline`).

`stage` (pad, copy into pinned memory, start the non-blocking H2D copy:
the host part) runs on a worker thread one chunk ahead of `dispatch` (the
kernel launches, cheap to issue and ordered), so chunk N+1's host work and
transfer overlap chunk N's device work. Dispatch stays on the caller's
thread because the bank carry makes it serial. The `stage_h2d` fault seam
fires on the worker before each chunk is staged; an injected (or real)
staging failure re-raises on the caller's thread, inside the dispatcher's
run, where it classifies as retryable (nothing committed).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, List

from redisson_tpu_torch.fault import inject as fault_inject

_STOP = object()


class StagingPipeline:
    """Overlap host staging of chunk N+1 with device dispatch of chunk N.

    `depth` bounds how many staged chunks may wait ahead of the dispatcher.
    """

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth

    def run(self, chunks: Iterable[Any], stage: Callable[[Any], Any],
            dispatch: Callable[[int, Any], Any]) -> List[Any]:
        """stage(chunk) on the worker thread; dispatch(i, staged) here.

        Returns dispatch results in order. A staging exception re-raises on
        the caller's thread after in-flight dispatches drain; a dispatch
        exception stops the worker promptly.
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        failure: List[BaseException] = []

        def worker() -> None:
            try:
                for i, chunk in enumerate(chunks):
                    if stop.is_set():
                        return
                    fault_inject.fire("stage_h2d")
                    q.put((i, stage(chunk)))
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                failure.append(exc)
            finally:
                q.put(_STOP)

        t = threading.Thread(target=worker, name="ingest-stager", daemon=True)
        t.start()
        results: List[Any] = []
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                i, staged = item
                results.append(dispatch(i, staged))
        finally:
            stop.set()
            # Keep draining until the worker exits: it may be parked on a
            # full queue (early dispatch failure) with more puts pending.
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)
            t.join()
        if failure:
            raise failure[0]
        return results
