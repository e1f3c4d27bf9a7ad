"""The port's benchmark: run one cell with `python3 perfbench/run.py`."""
