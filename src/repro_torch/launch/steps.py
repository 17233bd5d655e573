"""The QA-LoRA train step (counterpart of ``make_train_fn`` in
``repro.launch.steps``).

Gradients flow ONLY to the adapters: the quantized base is a set of
buffers, so autograd builds no gradient for it and the optimizer keeps no
state for it.  On CUDA every ``qalora`` linear's forward is kernel 3
(with its rank projection) through ``ops._QALoRAMatmul``, launched again
in the backward when ``cfg.remat`` recomputes the block; the backward
itself is plain PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.partition import trainable_tensors


def make_train_fn(lm: LM, opt_cfg: AdamWConfig):
    """Returns ``train_step(params, opt_state, batch) -> metrics``: the
    loss, the backward over the trainable tensors only, then
    :func:`adamw_update` in place on ``params``' adapters and
    ``opt_state``.  Metrics (f32 device scalars): ``loss``, ``xent``,
    ``aux``, ``grad_norm`` and ``lr``."""

    def train_step(params, opt_state, batch):
        trainable = trainable_tensors(params)
        loss, metrics = lm.loss(params, batch)
        grads = torch.autograd.grad(loss, list(trainable.values()))
        om = adamw_update(opt_cfg, dict(zip(trainable, grads)), opt_state,
                          trainable)
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step
