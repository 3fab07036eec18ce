"""Pricing provider.

Mirrors pkg/providers/pricing/pricing.go:49-453: on-demand and zonal spot
price lookups backed by a refreshable source, with a static fallback (the
catalog's embedded prices play the role of zz_generated.pricing.go), a 12h
refresh loop hook, and a change monitor that reports only on updates.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

from ..cache import PRICING_REFRESH_PERIOD
from ..models import labels as L
from ..models.instancetype import InstanceType
from ..utils.clock import Clock

PriceSource = Callable[[], Iterable[Tuple[str, str, str, float]]]
# yields (instance_type, zone, capacity_type, price)


class PricingProvider:
    def __init__(
        self,
        instance_types: Iterable[InstanceType] = (),
        source: Optional[PriceSource] = None,
        clock: Optional[Clock] = None,
        refresh_period: float = PRICING_REFRESH_PERIOD,
        isolated_vpc: bool = False,
    ) -> None:
        self.clock = clock or Clock()
        self.refresh_period = refresh_period
        self.source = source
        # isolated VPCs can't reach the pricing API: stay on the static
        # fallback and never poll (pricing.go:121-123)
        self.isolated_vpc = isolated_vpc
        self._od: Dict[str, float] = {}
        self._spot: Dict[Tuple[str, str], float] = {}
        self._last_refresh = -1e18
        self.updates = 0  # change-monitor counter
        # static fallback (InitialOnDemandPrices analog)
        for it in instance_types:
            for o in it.offerings:
                if o.capacity_type == L.CAPACITY_TYPE_ON_DEMAND:
                    self._od.setdefault(it.name, o.price)
                else:
                    self._spot.setdefault((it.name, o.zone), o.price)

    # ---- lookups (pricing.go:177-202) ----------------------------------
    def on_demand_price(self, instance_type: str) -> Optional[float]:
        return self._od.get(instance_type)

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        got = self._spot.get((instance_type, zone))
        if got is not None:
            return got
        # fall back to any-zone spot like the reference's zone-less lookup
        for (t, _z), p in self._spot.items():
            if t == instance_type:
                return p
        return None

    def price(self, instance_type: str, zone: str, capacity_type: str) -> Optional[float]:
        if capacity_type == L.CAPACITY_TYPE_SPOT:
            return self.spot_price(instance_type, zone)
        return self.on_demand_price(instance_type)

    # ---- refresh loop (pricing.go:84-152) -------------------------------
    def maybe_refresh(self) -> bool:
        if self.source is None or self.isolated_vpc:
            return False
        now = self.clock.now()
        if now - self._last_refresh < self.refresh_period:
            return False
        self._last_refresh = now
        changed = False
        for t, zone, ct, price in self.source():
            if ct == L.CAPACITY_TYPE_ON_DEMAND:
                if self._od.get(t) != price:
                    self._od[t] = price
                    changed = True
            else:
                if self._spot.get((t, zone)) != price:
                    self._spot[(t, zone)] = price
                    changed = True
        if changed:
            self.updates += 1  # pretty.ChangeMonitor analog: count real changes
        return changed

    def liveness_ok(self) -> bool:  # pragma: no cover - trivial
        return True

    def apply(self, instance_types: Iterable[InstanceType]) -> None:
        """Stamp current prices onto a catalog's offerings in place."""
        for it in instance_types:
            for o in it.offerings:
                p = self.price(it.name, o.zone, o.capacity_type)
                if p is not None:
                    object.__setattr__(o, "price", p)
