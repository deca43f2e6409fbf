"""The paper's CNN float trainer (the recipe of the reference's
`benchmarks/common.py::train_cnn`): AdamW with a cosine schedule on the
synthetic gratings task, optionally with 2:4 masked retraining (paper
§5.3: prune from the trained network, keep training), then BatchNorm
running statistics set from fresh training batches.

    model = train_cnn()                        # on the card, ~420 steps
    pruned = train_cnn(prune_2_4=True)         # 630 steps, 2:4 from 157

A model is {"cfg", "params", "losses"} and goes straight into
`launch/cnn_eval.py` (calibration, quantized accuracy). Nothing is
cached to disk. The data are drawn from seeded `torch.Generator`s on the
device (other numbers than the reference's `jax.random` draws); tests
hand in numpy batches instead.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.cnn_eval import SEED, prune_cnn
from repro_torch.launch.train import value_and_grad
from repro_torch.models import cnn
from repro_torch.optim.adamw import AdamW, cosine_schedule

TRAIN_STEPS = 420
BATCH = 96
N_BN_BATCHES = 16


def default_config() -> cnn.CNNConfig:
    """The reference trainer's network: width 24, one block a stage in
    three stages, 8 classes, 24 x 24 images."""
    return cnn.CNNConfig(width=24, stages=(1, 1, 1), num_classes=8,
                         img_size=24)


def _on(batch: Dict, dev) -> Dict:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                ).to(dev) for k, v in batch.items()}


def train_cnn(cfg: Optional[cnn.CNNConfig] = None,
              steps: Optional[int] = None, prune_2_4: bool = False,
              seed: int = SEED, batches: Optional[List[Dict]] = None,
              device=None) -> Dict:
    """Train a seeded mini-ResNet. `steps` defaults to 420, or 630 with
    2:4 pruning, which prunes every conv but the stem after each step
    from `steps // 4` on and once more at the end. After training, BN's
    running statistics are recalibrated on 16 fresh batches. `batches`
    (numpy or tensors, {"image", "label"}) replaces the drawn data: the
    first `steps` train, the rest recalibrate BN."""
    dev = resolve_device(device)
    steps = steps or (3 * TRAIN_STEPS // 2 if prune_2_4 else TRAIN_STEPS)
    cfg = cfg or default_config()
    params = cnn.init_params(torch.Generator(device=dev).manual_seed(seed),
                             cfg, dev)
    if batches is None:
        g_train = torch.Generator(device=dev).manual_seed(seed + 1)
        g_bn = torch.Generator(device=dev).manual_seed(seed + 2)
        train_b = (cnn.synthetic_dataset(g_train, cfg, BATCH, dev)
                   for _ in range(steps))
        bn_b = [cnn.synthetic_dataset(g_bn, cfg, BATCH, dev)
                for _ in range(N_BN_BATCHES)]
    else:
        train_b = (_on(b, dev) for b in batches[:steps])
        bn_b = [_on(b, dev) for b in batches[steps:]]

    opt = AdamW(lr=cosine_schedule(3e-3, 20, steps), weight_decay=1e-4)
    state = opt.init(params)
    losses = []
    for i, batch in enumerate(train_b):
        loss, _, grads = value_and_grad(
            lambda p: cnn.loss_fn(p, batch, cfg), params)
        params, state, _ = opt.update(grads, state, params)
        losses.append(loss)
        if prune_2_4 and i >= steps // 4:   # prune, then keep training
            params = prune_cnn(params)
    # the train loop normalizes with batch statistics and never keeps BN's
    # running ones: set them from the training distribution before eval
    params = cnn.recalibrate_bn(params, bn_b, cfg)
    if prune_2_4:
        params = prune_cnn(params)
    return {"cfg": cfg, "params": params,
            "losses": [float(x) for x in losses]}
