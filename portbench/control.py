"""The control of `correct`: a whole run of a cell with the control's
verdicts in the program's place.

    python3 portbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell as `portbench/run.py` makes it, at the
cell's own size and load, with the timed path's verdicts replaced where
they are produced (the engine's `fetch`) by the control's: the plain
reference with the hole patch left out (portbench/reference/verdicts.py),
for the same candidates in the same launches. The run's own comparison
(harness/checks.py `judge`) then decides `correct`, and has to come out
false on every seed. Prints one line a seed: the compared numbers beside
their limits. Exits 0 only when every seed comes out not correct. Needs the
cards the cell asks for.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import cell_run, spec  # noqa: E402
from portbench.reference import curves, verdicts  # noqa: E402

cell_run.use_checkout_caches(ROOT)


def control_in_place(curve_name: str):
    """A `wrap` for harness/drive.py: each launch's verdicts, as `fetch`
    returns them, become the control's for the launch's candidates."""

    def wrap(engine, pool, requests):
        ctl = verdicts.control_verdicts(curves.curve(curve_name), pool.n, pool.sks,
                                        pool.candidate_messages(), pool.words, pool.sigs)
        R = pool.request_candidates
        # the service hands the engine the requests' own signature objects
        by_sig = {id(sig): ctl[r * R + i]
                  for r, req in enumerate(requests) for i, (_bs, sig) in enumerate(req)}
        dispatch, fetch = engine.dispatch, engine.fetch
        launched: dict = {}

        def dispatch_(msg, reqs):
            handle = dispatch(msg, reqs)
            launched[id(handle)] = [by_sig[id(sig)] for _bs, sig in reqs]
            return handle

        def fetch_(handle):
            out = fetch(handle)
            return launched.pop(id(handle))[: len(out)]

        engine.dispatch, engine.fetch = dispatch_, fetch_

    return wrap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench control: {cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    wrap = control_in_place(cell.config["curve"])
    all_failed = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = cell_run.run_cell(cell, seed, args.seconds, False, "cuda", t0, wrap=wrap)
        all_failed &= out["correct"] is False
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
