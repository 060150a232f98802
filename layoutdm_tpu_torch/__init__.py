"""layoutdm_tpu_torch — the PyTorch + CUDA port of ``layoutdm_tpu``.

The package mirrors ``layoutdm_tpu``'s module paths and names
(``layoutdm_tpu/ops/attention.py`` <-> ``layoutdm_tpu_torch/ops/attention.py``)
and keeps its tensor layouts at public functions (the packed ``[q|k|v]``
slab, vocabulary on the last axis), so each module can be held against its
JAX counterpart.  It imports ``torch`` and never ``jax``, and nothing of
``layoutdm_tpu``: the modules it shares with it (``configs``, ``registry``,
``data``, ``train/schedulers``, ``utils/tb``, ``utils/visualization``) are
its own copies, so a ``config.json`` means the same in both packages.

It covers the flagship LayoutDM serving and training paths: tokenizer,
denoiser, constrained posterior, reverse chain, task conditions, loss,
AdamW step, trainer and the HTTP service.  Each Pallas kernel on those
paths is a hand-written CUDA kernel for Hopper under ``csrc/``, built with
``nvcc`` at first use: the packed-qkv attention (``attention_qkv.cu``) and
its backward (``attention_qkv_bwd.cu``); and, on the fused denoiser path
(``LAYOUTDM_TPU_FUSED_BLOCK=1``, ``LAYOUTDM_TPU_FUSED_FFN=1``), the whole
attention block (``attention_block.cu``) and the LayerNorm-FFN-residual
(``ffn.cu``).  Entry points run on CUDA unless given ``device="cpu"``.

Beside the model it carries the user path around it: the ingest CLI
(``data/ingest.py``), the metric suite (``eval/metrics.py``, on a C++ host
engine in ``native/``), the FIDNet feature extractor and its trainer
(``eval/fidnet.py``, ``eval/fidnet_train.py``; plain PyTorch ops on the
card, as the JAX package runs them in plain XLA), ``eval_cli`` and
``render_cli``.
"""

__version__ = "0.1.0"
