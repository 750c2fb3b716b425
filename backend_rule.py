#!/usr/bin/env python3
"""Pool the backend phase's sessions and derive the H100 backend rule.

    python3 backend_rule.py S1.json S2.json S3.json

Each file is one session of ``chip_smoke.py --phases card,backend
--backend-out FILE`` (one process each).  For every shape the script prints
each session's median milliseconds a step through the kernels
(``pallas``) and through the plain path (``jnp``), the pooled medians, the
faster, and whether the samples separate: the loser's pooled median
outside the winner's interquartile range (``autotune.separates``, the test
of ``nmf_tpu/utils/device.py:68-74``).  The decision leaves the kernels
only where ``jnp`` is faster and the samples separate; a tie keeps the
kernels.  The last column is the rule the sessions ran
(``autotune.rule_pick``, ``tile_sparse.preferred``); the exit code is 1 if
any decision differs from it.
"""

import json
import statistics
import sys


def main(paths) -> int:
    from nmf_tpu_torch.utils.autotune import separates

    sessions = [json.load(open(p)) for p in paths]
    cards = {s["card"] for s in sessions}
    print(f"sessions: {len(sessions)}; card: {' / '.join(sorted(cards))}")
    print("| Shape | kernels ms (per session) | plain ms (per session) | pooled kernels / plain "
          "| faster | separates | decision | rule |")
    print("|---|---|---|---|---|---|---|---|")
    differ = []
    for label in sessions[0]["measured"]:
        runs = [s["measured"][label] for s in sessions]
        pooled = {b: [t for r in runs for t in r["samples"][b]] for b in ("pallas", "jnp")}
        med = {b: statistics.median(v) for b, v in pooled.items()}
        faster = "jnp" if med["jnp"] < med["pallas"] else "pallas"
        loser = "pallas" if faster == "jnp" else "jnp"
        sep = separates(pooled[faster], pooled[loser])
        decision = "jnp" if faster == "jnp" and sep else "pallas"
        rules = {r["rule"] for r in runs}
        rule = rules.pop() if len(rules) == 1 else "mixed"
        if decision != rule:
            differ.append(label)

        def per(b):
            return " / ".join(f"{r['median'][b]:.4f}" for r in runs)

        print(f"| {label} | {per('pallas')} | {per('jnp')} | {med['pallas']:.4f} / "
              f"{med['jnp']:.4f} | {faster} | {'yes' if sep else 'no'} | {decision} | {rule} |")
    if differ:
        print(f"decisions that differ from the rule: {differ}")
        return 1
    print("every decision is the rule's")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
