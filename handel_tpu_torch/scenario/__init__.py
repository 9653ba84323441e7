"""WAN scenario engine: geo-latency planets, churn, stake weights. A copy of
handel_tpu/scenario/.

`python -m handel_tpu_torch.sim scenario --config <toml>` runs one; `confgen
--scenario geo|churn|weighted` emits ready-to-run TOMLs (sim/confgen.py).
"""

from handel_tpu_torch.scenario.engine import run_scenario, run_scenario_sync
from handel_tpu_torch.scenario.membership import MembershipEvent, MembershipSchedule
from handel_tpu_torch.scenario.planets import PLANETS, planet_names, planet_preset
from handel_tpu_torch.scenario.weights import PROFILES, make_weights

__all__ = [
    "run_scenario",
    "run_scenario_sync",
    "MembershipEvent",
    "MembershipSchedule",
    "PLANETS",
    "planet_names",
    "planet_preset",
    "PROFILES",
    "make_weights",
]
