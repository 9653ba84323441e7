"""Named planet presets: region lists + symmetric RTT matrices (ms) — a
copy of handel_tpu/scenario/planets.py.

The numbers are representative public-cloud inter-region RTTs, rounded —
the point is the SHAPE (one close pair, one far pair, a mid band), not
basis-point accuracy. Scenarios reference a preset by name in the
`[scenario]` TOML section (`planet = "planet-5region"`) or supply an
inline `regions` + `rtt_ms` matrix instead.
"""

from __future__ import annotations

PLANETS: dict[str, tuple[list[str], list[list[float]]]] = {
    # one continent-local pair, one transpacific pair
    "planet-3region": (
        ["eu-west", "us-east", "ap-east"],
        [
            [4.0, 80.0, 220.0],
            [80.0, 4.0, 170.0],
            [220.0, 170.0, 4.0],
        ],
    ),
    # the 5-region capture shape: two US coasts, Europe, Asia, South America
    "planet-5region": (
        ["eu-west", "us-east", "us-west", "ap-east", "sa-south"],
        [
            [4.0, 80.0, 140.0, 220.0, 190.0],
            [80.0, 4.0, 65.0, 170.0, 115.0],
            [140.0, 65.0, 4.0, 110.0, 175.0],
            [220.0, 170.0, 110.0, 4.0, 300.0],
            [190.0, 115.0, 175.0, 300.0, 4.0],
        ],
    ),
    # a deliberately tiny planet for fast CI smokes: same structure, RTTs
    # an order of magnitude down so a 32-node run converges in seconds
    "planet-3region-fast": (
        ["eu-west", "us-east", "ap-east"],
        [
            [0.5, 8.0, 22.0],
            [8.0, 0.5, 17.0],
            [22.0, 17.0, 0.5],
        ],
    ),
}


def planet_names() -> list[str]:
    return sorted(PLANETS)


def planet_preset(name: str) -> tuple[list[str], list[list[float]]]:
    """(regions, rtt_ms) for a named preset; copies, safe to mutate."""
    try:
        regions, rtt = PLANETS[name]
    except KeyError:
        raise ValueError(
            f"unknown planet {name!r} (known: {', '.join(planet_names())})"
        ) from None
    return list(regions), [list(row) for row in rtt]
