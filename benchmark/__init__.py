"""The benchmark of `sonic_tpu_torch`, the PyTorch and CUDA port of Sonic.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository's root names the cells; each cell's
configuration (`configs/`), traffic mix (`traffic/`) and metrics
(`metrics/`) are files of their own, found by name. `gen` makes every
input from the seed, `reference` and `g1` work out every proof element
again from the trapdoor in plain Python, and `trace` reduces timers,
counters and the profiler's trace to the per-layer metrics. Nothing here
imports jax or the JAX package; the reference modules import nothing of
the port either.
"""
