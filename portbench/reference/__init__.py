"""The plain check that decides a run's `correct`: plain PyTorch and
python ints, importing nothing of the program (see check.py)."""
