"""The readings that a cell's limits are set from, on the card, in one
process: for each seed every number of the cell's family
(``families/<family>.py``), the program against the reference (the lower
readings), and on the first ``--variant-seeds`` seeds those of the
reference put in the program's place (``--variants``: the fp8 control, half
of each batch left out, bf16; the upper readings).
Each seed is a whole set-up and the followed steps of the cell at its own
sizes, with a short window.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 [--variant-seeds 3]

Writes one JSON line a seed to standard output and to
``chiprun_out/calibrate_<cell>.jsonl``.
"""

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--variant-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--variants", default="control,half",
                   help="the reference put in the program's place: control (fp8), half "
                        "(half of each batch), bf16 (the configuration's own precision)")
    p.add_argument("--detail", action="store_true",
                   help="write each leaf's norms to chiprun_out/detail_<cell>_<seed>.json")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, manifest, run

    run._environment()
    man = manifest.Manifest(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = out_dir / f"calibrate_{args.workload}.jsonl"
    with open(out, "a") as f:
        for k in range(args.seeds):
            seed = args.first_seed + 7919 * k
            variants = tuple(args.variants.split(",")) if k < args.variant_seeds else ()
            t0 = time.perf_counter()
            res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", t0,
                                   man=man, variants=variants, detail=args.detail,
                                   readings=True)
            if args.detail:
                (out_dir / f"detail_{args.workload}_{seed}.json").write_text(
                    json.dumps(res["detail"]))
            line = dict(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0,
                        readings=res["readings"], correct=res["correct"],
                        card=torch.cuda.get_device_name(0))
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
