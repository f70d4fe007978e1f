"""The benchmark of the PyTorch and CUDA port (``tpu_operator_torch``).

One run times one cell of ``BENCHMARK.json`` on the card and checks what
the timed passes computed against a plain reference: ``python3
gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Everything a cell needs is found by name: its configuration under
``configs/``, its traffic mix under ``mixes/``, the entries its calls name
under ``entries/``, the kinds of answer they compute under ``kinds/`` and
one reader per metric under ``metrics/``.
"""
