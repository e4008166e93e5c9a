"""Refresh dry-run records from their saved op traces (port of
``repro.launch.reanalyze``): a change to the cost model's sums applies
offline, with no step run again.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir artifacts/dryrun_torch]
"""
import argparse
import glob
import json
import os

from repro_torch.launch import cost_analysis
from repro_torch.launch.dryrun import ARTIFACTS, record_costs


def reanalyze(path: str) -> bool:
    """Sum the trace of the record at ``path`` again and write it back;
    False when the record is not ``ok`` or has no trace."""
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return False
    stem = os.path.basename(path)[:-len(".json")]
    trace = os.path.join(os.path.dirname(path), "ops", stem + ".jsonl.gz")
    if not os.path.exists(trace):
        print(f"[miss] {stem}: no op trace")
        return False
    _, records = cost_analysis.load_trace(trace)
    costs = cost_analysis.summarize(records)
    record_costs(rec, costs)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[ok] {stem}: flops {costs.dot_flops:.3e} hbm {costs.hbm_bytes / 1e9:.2f} GB "
          f"coll {costs.collective_bytes / 1e9:.3f} GB")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=ARTIFACTS)
    args = ap.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        reanalyze(path)


if __name__ == "__main__":
    main()
