"""Faults planted in the program underneath a run, to show that the
comparison catches them (the benchmark's own runs never plant one).

- ``frozen``: each reverse step returns its state unchanged (the
  posterior put on the ids the step started from);
- ``token``: one token of every row altered where the chain draws it,
  at every step."""

from __future__ import annotations


def frozen(model) -> None:
    from layoutdm_tpu_torch.ops.log_math import log_onehot

    q = model.q
    q.q_posterior_ids = lambda log_x0, ids, t: log_onehot(ids, q.num_classes)


def token(model) -> None:
    import layoutdm_tpu_torch.models.diffusion.sampler as sampler

    draw = sampler.sample_tokens

    def altered(*a, **k):
        ids = draw(*a, **k).clone()
        ids[:, 0] = (ids[:, 0] + 1) % model.tokenizer.N_category
        return ids

    sampler.sample_tokens = altered
