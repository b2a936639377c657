"""RGeo — geospatial index (reference: `RedissonGeo.java` over
GEOADD/GEODIST/GEOPOS/GEORADIUS; here radius queries are one vectorized
numpy haversine over the whole structure, `structures/extended.py`)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch.models.expirable import RExpirable


class RGeo(RExpirable):
    def _e(self, v: Any) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw) -> Any:
        return None if raw is None else self._codec.decode(raw)

    def add(self, longitude: float, latitude: float, member: Any) -> int:
        return self.add_entries((longitude, latitude, member))

    def add_entries(self, *entries: Tuple[float, float, Any]) -> int:
        payload = [(lon, lat, self._e(m)) for lon, lat, m in entries]
        return self._executor.execute_sync(self.name, "geoadd", {"entries": payload})

    def pos(self, *members: Any) -> Dict[Any, Tuple[float, float]]:
        raw = self._executor.execute_sync(
            self.name, "geopos", {"members": [self._e(m) for m in members]}
        )
        return {self._d(m): coords for m, coords in raw.items()}

    _GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"

    def hash(self, *members: Any) -> Dict[Any, Optional[str]]:
        """Reference hash() -> GEOHASH strings (11-char base32 geohash of
        each member's position, computed from the stored coordinates).
        Matches Redis GEOHASH exactly: ten characters from the first 50 of
        its 52 interleaved bits, and a literal '0' eleventh character
        (Redis discards the last two bits and hard-codes that char —
        geohashCommand in geo.c). Members with no stored position map to
        None, mirroring GEOHASH's per-member nil reply — callers can tell
        'missing member' from 'not queried'."""
        pos = self.pos(*members)
        out: Dict[Any, Optional[str]] = {m: None for m in members}
        for member, (lon, lat) in pos.items():
            lat_rng, lon_rng = [-90.0, 90.0], [-180.0, 180.0]
            bits = []
            even = True
            while len(bits) < 50:
                rng, v = (lon_rng, lon) if even else (lat_rng, lat)
                mid = (rng[0] + rng[1]) / 2
                if v >= mid:
                    bits.append(1)
                    rng[0] = mid
                else:
                    bits.append(0)
                    rng[1] = mid
                even = not even
            s = ""
            for i in range(0, 50, 5):
                idx = 0
                for b in bits[i:i + 5]:
                    idx = (idx << 1) | b
                s += self._GEOHASH32[idx]
            out[member] = s + "0"
        return out

    def dist(self, member1: Any, member2: Any, unit: str = "m") -> Optional[float]:
        return self._executor.execute_sync(
            self.name,
            "geodist",
            {"m1": self._e(member1), "m2": self._e(member2), "unit": unit},
        )

    def radius(
        self,
        longitude: float,
        latitude: float,
        radius: float,
        unit: str = "m",
        count: Optional[int] = None,
    ) -> List[Any]:
        hits = self._executor.execute_sync(
            self.name,
            "georadius",
            {"lon": longitude, "lat": latitude, "radius": radius, "unit": unit, "count": count},
        )
        return [self._d(m) for m, _, _ in hits]

    def radius_with_distance(
        self, longitude: float, latitude: float, radius: float, unit: str = "m",
        count: Optional[int] = None,
    ) -> Dict[Any, float]:
        hits = self._executor.execute_sync(
            self.name,
            "georadius",
            {"lon": longitude, "lat": latitude, "radius": radius, "unit": unit, "count": count},
        )
        return {self._d(m): d for m, d, _ in hits}

    def radius_with_position(
        self, longitude: float, latitude: float, radius: float, unit: str = "m",
        count: Optional[int] = None,
    ) -> Dict[Any, Tuple[float, float]]:
        hits = self._executor.execute_sync(
            self.name,
            "georadius",
            {"lon": longitude, "lat": latitude, "radius": radius, "unit": unit, "count": count},
        )
        return {self._d(m): pos for m, _, pos in hits}

    def radius_by_member(
        self, member: Any, radius: float, unit: str = "m", count: Optional[int] = None
    ) -> List[Any]:
        hits = self._executor.execute_sync(
            self.name,
            "georadius",
            {"member": self._e(member), "radius": radius, "unit": unit, "count": count},
        )
        return [self._d(m) for m, _, _ in hits]
