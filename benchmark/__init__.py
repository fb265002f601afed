"""The benchmark of ``deeplabv3plus_keras_tpu_torch`` on NVIDIA H100 cards.

One run is ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; the cells,
configurations, traffic mixes and metrics are named in ``BENCHMARK.json``
and found by name under this directory (``cells.py``).
"""
