"""WAN scenario plane — the part of handel_tpu/scenario/ that the port has:
the named planet presets (planets.py) that the geo model (network/geo.py)
and `[scenario] planet = ...` read. The scenario engine, membership
schedules and stake weights are not ported yet (ROADMAP items 8a-8d).
"""

from handel_tpu_torch.scenario.planets import PLANETS, planet_names, planet_preset

__all__ = ["PLANETS", "planet_names", "planet_preset"]
