"""Readings for the limits of a cell's check: the numbers of the program's
own jobs and of the control, seed by seed, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 [--jobs 2] [--control 1]

For each seed the cell's inputs are made, ``--jobs`` jobs run as the window
runs them (the same entry at the same sizes, from empty caches), the program's
state is freed and the job kind's check compares their outputs with the
plain reference. With ``--control 1`` the job kind's control (the reference
in bfloat16 put in the program's place; the stitch job's registers to whole
pixels as well) is compared the same way. One JSON
line a seed, then the largest program number and the smallest control number
of each name.
"""

import os
import sys
import tempfile
import shutil
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "portbench":
    sys.path.pop(0)
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def main(argv=None, root=_ROOT, device="cuda") -> int:
    import argparse
    import json

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cell = harness.load_cell(root, args.workload)
    Job = harness.job_class(cell)
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="portbench-readings-")
        try:
            job = Job(cell.config, cell.traffic, seed, device, workdir)
            job.setup()
            outputs = {}
            for k in range(args.jobs):
                job.before(k)
                outputs[k] = job.run(k)["output"]
            job.release()
            nums = job.check(outputs)
            del outputs
            line = {"seed": seed, "program": nums}
            if args.control:
                line["control"] = job.control()
            job.close()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for k, v in nums.items():
            program[k] = max(program.get(k, v), v)
        for k, v in line.get("control", {}).items():
            control[k] = min(control.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": program,
                      "control_min": control}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main(sys.argv[1:]))
