"""The benchmark of the PyTorch and CUDA port (``unitygaussiansplatting_torch``)
on H100 cards: ``python3 splatbench/run.py --workload <name> ...``.  See README.md."""
