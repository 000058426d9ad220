"""Unified CLI — the operator surface the reference provides as GRC
flowgraphs (grc/ampsbs.grc, grc/ampsbs_rvc.grc, grc/recctest.grc).

    python -m amps_tpu bs       [...]   # BS-in-a-box (ampsbs.grc role)
    python -m amps_tpu monitor  [...]   # RECC capture replay (recctest.grc)
    python -m amps_tpu demo             # end-to-end loopback walkthrough
    python -m amps_tpu bench            # headline GPU benchmark

Each subcommand forwards to the corresponding application module; run
with -h for its options.
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # the application modules live next to the package in a source tree
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    cmd = argv.pop(0) if argv else "help"
    if cmd == "bs":
        from apps.bs_app import main as m
        return m(argv)
    if cmd == "monitor":
        from apps.recc_monitor import main as m
        return m(argv)
    if cmd == "demo":
        from examples.bs_loopback_demo import main as m
        return m()
    if cmd == "bench":
        import runpy
        sys.argv = ["bench.py"] + argv
        return runpy.run_path(os.path.join(root, "bench.py"),
                              run_name="__main__")
    print(__doc__.strip())
    return 0 if cmd in ("help", "-h", "--help") else 2


if __name__ == "__main__":
    raise SystemExit(main())
