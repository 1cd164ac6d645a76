"""The control of a cell's comparison, and a sound reading beside it.

    python3 -m texbench.control --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs at the cell's own size on the
card and reads the comparison's numbers twice: once for the port (one
unit of the cell's traffic through the timed entry point) and once for
the control, the reference put in the port's place with one step that
would tempt a later change: for the fleet cells ETC1 encoded under the
heuristic strategy (breaking the byte-identity the configuration states),
for a request cell its codec's HQ fit one precision lower (bfloat16 for
float32). The control has to read above every limit the sound runs keep.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from texbench import drive
from texbench.manifest import Manifest


def readings(cell: str, seed: int, device="cuda", *, config=None,
             mix=None) -> dict:
    """{"program": readings, "control": readings} for one seed."""
    if config is None or mix is None:
        man = Manifest()
        c = man.cell(cell)
        config = man.config(c["config"]) if config is None else config
        mix = man.traffic(c["traffic"]) if mix is None else mix
    client = drive.make(config, mix, seed, device)
    units = len(client.images) if hasattr(client, "images") else 1
    for _ in range(units):
        client.unit()
    program = client.check()[0]
    client.control_answers()
    control = client.check()[0]
    client.release()
    return {"program": {k: v for k, (v, _) in program.items()},
            "control": {k: v for k, (v, _) in control.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("texbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
