"""Print the largest collectives of a saved dry-run op trace (port of
``repro.launch.topcolls``, which reads a dumped cell HLO).

    PYTHONPATH=src python -m repro_torch.launch.topcolls \\
        artifacts/dryrun_torch/ops/<cell>.jsonl.gz [N]

Eager torch dispatches every loop iteration's ops, so each collective in
the trace is one that ran: no trip weighting is needed.
"""
import sys

from repro_torch.launch.cost_analysis import load_trace


def top_collectives(records, n: int = 10):
    """``([(bytes, kind, op), ...] largest first, at most n; total bytes)``."""
    colls = [(float(r["coll_bytes"]), r["coll"], f"{r['op']} {r['outs']}")
             for r in records if r.get("coll")]
    colls.sort(reverse=True)
    return colls[:n], sum(c[0] for c in colls)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    _, records = load_trace(argv[0])
    top, total = top_collectives(records, int(argv[1]) if len(argv) > 1 else 10)
    print(f"total {total / 1e9:.3f} GB")
    for b, kind, line in top:
        print(f"  {b / 1e9:10.3f} GB {kind:18s} {line[:100]}")


if __name__ == "__main__":
    main()
