"""The one generator of traffic, driven by a mix's parameters.

A mix (``traffic/<name>.json``) is one of:

* ``{"kind": "closed", "outstanding": N, ...}``: N requests always
  outstanding; each completion sends the next;
* ``{"kind": "poisson", "rate_per_s": R, "burst": null | {"on_s", "off_s"},
  ...}``: an open loop.  Exactly ``round(R * seconds)`` arrivals, placed as
  a Poisson process conditioned on its count places them (sorted uniform
  times), so every seed sends the same number of requests, in another
  order; with ``burst`` the arrivals fall only in the on periods of an
  on/off cycle, at the same mean rate.

Every mix also names ``pool`` (distinct inputs, request i takes input
i mod pool) and ``queue_capacity`` (the engine's admission queue).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

#: the seed's sub-stream for arrival times (the inputs and weights draw
#: from the card's generator, seeded with the seed itself)
ARRIVALS = 1


def arrivals(traffic: dict, seconds: float, seed: int
             ) -> Optional[np.ndarray]:
    """Scheduled arrival times in [0, seconds), or None for a closed loop."""
    kind = traffic["kind"]
    if kind == "closed":
        return None
    if kind != "poisson":
        raise ValueError(f"unknown traffic kind {kind!r}")
    n = int(round(traffic["rate_per_s"] * seconds))
    rng = np.random.default_rng([seed, ARRIVALS])
    burst = traffic.get("burst")
    if not burst:
        return np.sort(rng.uniform(0.0, seconds, n))
    on, off = float(burst["on_s"]), float(burst["off_s"])
    u = np.sort(rng.uniform(0.0, seconds * on / (on + off), n))
    return (u // on) * (on + off) + u % on
