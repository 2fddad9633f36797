"""The benchmark of ferreus_rbf_tpu_torch on one CUDA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``README.md``.
Everything here imports torch, numpy and the port only.
"""
