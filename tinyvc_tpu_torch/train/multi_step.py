"""K steps per dispatch over the device-resident cache (counterpart of
`tinyvc_tpu/train/multi_step.py`).

With ``--device-data`` the whole chunk cache lives on the device, so the
host need not come back between steps: a window runs K steps, each on a
device gather ``waves[idx]`` of the cache, and returns one metrics dict.
The host sends the window's ``[K, B]`` indices once and reads the metrics
only where it logs. JAX compiles the window as one ``lax.scan``; here it is
a Python loop over the same step, so a window is K single steps on the same
indices and keys, bit for bit (`tests/test_torch_encoder_loop.py`). The
indices and keys come from the loops (`train/loop.py`): ``np.random.
default_rng(seed + 4242)``'s ``choice(n, B, replace=n < B)`` stacked to
``[K, B]``, and ``split(key, K + 1)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..config import TinyVCConfig
from . import decoder_train, encoder_train


def effective_k(requested: int, *boundaries: int) -> int:
    """The largest K <= ``requested`` that divides every host-visible
    boundary (log and save intervals, the discriminator's join, the step
    budget; 0 or negative: none), so that no window straddles one; 1 when
    they leave no larger K."""
    k = max(int(requested), 1)
    for b in boundaries:
        if b and b > 0:
            k = math.gcd(k, int(b))
    return max(k, 1)


def _squash_metrics(ms: List[Dict]) -> Dict:
    """K steps' metrics -> one dict: each loss's last value, the sum of the
    ``skipped*`` counters (a skip anywhere in the window must show)."""
    return {k: (sum(m[k] for m in ms) if k.startswith("skipped") else ms[-1][k])
            for k in ms[-1]}


def make_encoder_multi_step(cfg: TinyVCConfig, distill: bool):
    """``fn(state, waves [n, L], f0s [n, F], teacher [n, Ft, D] or None,
    idx_kb [K, B], keys [K, 2]) -> metrics``: K encoder steps on ``state``
    (in place), step ``k`` on rows ``idx_kb[k]`` of the cache with key
    ``keys[k]``. The teacher is ignored when ``distill`` is False."""
    step = encoder_train.make_train_step(cfg, distill=distill)

    def multi(state, waves, f0s, teacher, idx_kb, keys):
        return _squash_metrics([
            step(state, waves[idx], f0s[idx], teacher[idx] if distill else None, key)
            for idx, key in zip(idx_kb, keys)])

    return multi


def make_decoder_multi_step(cfg: TinyVCConfig, d_join: bool, spec_loss_type: str = "ms-stft",
                            dtype_name: Optional[str] = None):
    """``fn(state, encoder, waves [n, L], idx_kb [K, B], keys [K, 2]) ->
    metrics``: K GAN steps of one join phase on ``state`` (in place)."""
    step = decoder_train.make_train_step(cfg, d_join, spec_loss_type, dtype_name)

    def multi(state, encoder, waves, idx_kb, keys):
        return _squash_metrics([step(state, encoder, waves[idx], key)
                                for idx, key in zip(idx_kb, keys)])

    return multi
