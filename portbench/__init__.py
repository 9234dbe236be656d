"""The benchmark of tmdiff_tpu_torch on one NVIDIA H100.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once and prints its result line;
`portbench.sweep` finds a serve mix's knee, `portbench.control` reads the
controls a cell's limits are set from. A cell's model is its
configuration's family: `families/<family>.py` builds the program's model
and makes its calls, `references/<family>.py` is its plain reference.
Nothing here imports JAX or the JAX package; the program under test is
imported only by the drivers (`serve.py`, `train.py`) and the families.
Tests: `python -m pytest portbench/tests` (CPU; the `cuda`-marked ones
skip without a card).
"""
