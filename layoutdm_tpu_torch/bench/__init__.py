"""The port's benches, run on the card (counterparts of the JAX package's
``bench.py`` and ``bin/bench_*.py``): each entry point raises without a
card unless given ``device="cpu"``, labels every row with the device, the
card and its power limit, and writes under ``--out``.

- ``python -m layoutdm_tpu_torch.bench`` (`headline`): T=100 layouts/s at
  B=1024 with its FLOP count and MFU, the train row and the S=500 row;
- `train`: train samples/s at B = 64, 256, 1024;
- `serve`: the HTTP service under load (sequential wide requests, 1 and 16
  concurrent batch-1 clients);
- `zoo`: sampling throughput of every model family and the T ladder;
- `e2e_bigshape`: train, sample all six tasks and score at S=500;
- `profile_trace`: device time by kernel from a ``torch.profiler`` trace;
- `int8`: int8 against bf16 GEMM chains at the flagship FFN shape.
"""
