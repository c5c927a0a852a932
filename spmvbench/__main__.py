"""``python3 -m spmvbench``: the same as ``python3 spmvbench/run.py``."""

from spmvbench.run import main

if __name__ == "__main__":
    raise SystemExit(main())
