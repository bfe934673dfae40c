"""The benchmark of ``deepvision_tpu_torch`` on one NVIDIA H100.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout runs one cell of ``BENCHMARK.json`` once.
Everything a cell names is found by name: ``configs/<config>.json`` (the
model's sizes, its tokenizer and the limits of the comparison with the
reference), ``traffic/<mix>.json`` (the mix's parameters and its driver),
``drivers/<driver>.py`` (the window: ``train``, ``serve``) and
``metrics/<metric>.py`` (one reader a per-layer metric, with its own
arithmetic).  ``reference/`` is the plain float32 model that decides
``correct``; ``traffic_gen/`` makes the inputs from the seed;
``pending.json`` holds cells that run but that no bound holds yet;
``probe.py`` runs a cell's control, a planted fault or a changed mix.
Nothing here imports JAX or the JAX package.
"""
