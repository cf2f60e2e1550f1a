"""Readings that a cell's limits are set from: the program against the
reference on many seeds, the control (the reference put in the program's
place at the next precision below the configuration's), and the faults of
the timed path planted in the reference put in its place (for a round:
``reference.rounds.LOCAL_FAULTS``, "swapped" and
``reference.rounds.SERVER_FAULTS``). No window is measured; the
benchmark's runs do not run this.

    python3 fedbench/calibrate.py --workload vgg16_table2_secagg \
        --seeds 11,12,13 --faults 3 --out calib.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run


def lm_readings(cell: dict, seed: int, faults: bool, device) -> dict:
    import torch

    from fedbench.frozen import seeds
    from fedbench.harness import lm_step
    config, traffic = cell["config"], cell["traffic"]
    base = seeds.base_seed(seed)
    prog = lm_step.Program(config, traffic, base, device)
    mine = lm_step.check_steps(prog, config, traffic, base, device)
    del prog
    torch.cuda.empty_cache()
    ref = lm_step.follow(config, traffic, base, device)
    out = {"seed": seed, "program": lm_step.compare(mine, ref)}
    if faults:
        out["control"] = lm_step.compare(
            lm_step.follow(config, traffic, base, device, prec="fp8"), ref)
        out["faults"] = {f: lm_step.compare(
            lm_step.follow(config, traffic, base, device, fault=f), ref)
            for f in ("half_batch", "altered")}
    return out


class Replaced:
    """The plain reference put in the round's place for its local SGD, at
    ``prec``, with ``fault`` planted: a local fault, or "swapped" (the
    round trains each client on the next client's batches)."""

    def __init__(self, config: dict, traffic: dict, device, *,
                 prec: str = "float32", fault: str | None = None):
        self.config, self.traffic, self.device = config, traffic, device
        self.prec, self.fault = prec, fault

    def local_sgd(self, params: dict, xs, ys, steps: int) -> tuple:
        from fedbench.reference import rounds
        fault = self.fault if self.fault in rounds.LOCAL_FAULTS else None
        got = rounds.local_sgd(self.config, self.traffic, params,
                               xs[:, :steps], ys[:, :steps], prec=self.prec,
                               fault=fault, device=self.device)
        return got["deltas"], got["losses"]

    def round_local(self, params: dict, xs, ys) -> tuple:
        """What its round's local SGD hands the server, on the CPU."""
        if self.fault == "swapped":
            xs, ys = xs.roll(-1, 0), ys.roll(-1, 0)
        deltas, losses = self.local_sgd(params, xs, ys,
                                        self.traffic["local_steps"])
        return {n: v.detach().cpu() for n, v in deltas.items()}, losses


def readings(cell: dict, seed: int, faults: bool, device) -> dict:
    import torch

    if cell["traffic"]["driver"] == "lm_step":
        return lm_readings(cell, seed, faults, device)
    from fedbench.harness import fl_round
    from fedbench.reference import rounds
    config, traffic = cell["config"], cell["traffic"]
    inputs = fl_round.make_inputs(config, traffic, seed, device)
    prog = fl_round.Program(config, traffic, inputs["base"], device)
    n = traffic["check_rounds"]
    state, mine = fl_round.check_rounds(prog, inputs, n)
    params0 = {k: v.detach().cpu() for k, v in inputs["params0"].items()}
    rnds, base = inputs["rounds"][:n], inputs["base"]
    del state, inputs
    torch.cuda.empty_cache()

    def server(ups, **kw):
        return rounds.follow_rounds(
            config, traffic, params0,
            [(c, d, ls) for (c, _, _), (d, ls) in zip(rnds, ups)],
            base=base, device=device, **kw)

    def held(who, params, ups):
        local = fl_round.check_local(who, config, traffic,
                                     [params0] + params[:-1], rnds, ups,
                                     device)
        return dict(local, **rounds.server_gaps(params0, params, server(ups)))

    out = {"seed": seed, "program": held(prog, mine["params"],
                                         mine["updates"])}
    del prog
    torch.cuda.empty_cache()

    def replaced(**kw):
        # the reference in the program's place: its own local updates,
        # round by round from the params its rounds reached
        who = Replaced(config, traffic, device, **kw)
        ups, params = [], []
        for c, xs, ys in rnds:
            ups.append(who.round_local(params[-1] if params else params0,
                                       xs, ys))
            params.append(server(ups)[-1])
        return held(who, params, ups)

    out["control"] = replaced(prec="tf32")
    if faults:
        out["faults"] = {f: replaced(fault=f)
                         for f in rounds.LOCAL_FAULTS + ("swapped",)}
        sound = server(mine["updates"])
        for f in rounds.SERVER_FAULTS:
            out["faults"][f] = rounds.server_gaps(
                params0, server(mine["updates"], fault=f), sound)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fedbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--faults", type=int, default=3,
                    help="read the faults (and, for an LM cell, the control) "
                         "on the first N seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run._environment()
    from fedbench.harness import manifest
    cell = manifest.cell(args.workload)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(cell, seed, i < args.faults, "cuda:0")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
