"""The port's adversarial train step against the JAX package's in float64
(JAX under x64, its critics built with dtype float64), from one carried
state at each parity, with JAX's draws fed to both (tests/test_torch_gan.py
has the setup and the f32 checks): the first step's gradients of the base
and of every critic (Adam's first moment after one step from zero is
(1 - b1) g) within 1e-6 of each leaf's largest, but where the soft-argmax
joints' f32 sets a floor (stated in the test)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_gan import _jax_grads, _np, _port, _setup, jax_draws


@pytest.mark.parametrize("parity", [0, 1])
def test_adversarial_step_f64_gradients_match_jax(rng, parity):
    """float64 on both sides (the JAX critics built with dtype float64; the
    fundamental term off: tests/test_torch_train.py holds its f64 gradient):
    the loss within 1e-6 (1.1e-8 measured), and the first step's gradients
    of the base and of every critic within 1e-6 of each leaf's largest; a
    leaf whose gradient is rounding noise (below 1e-6 of the model's
    largest) within 1e-6 of the model's largest; a critic with no loss at
    this parity has none.

    The floor: the heatmaps leave both models in f32, and the view and
    joints MI read their soft-argmax joints, which both packages compute in
    f32 (soft-argmax, inverse affine), 1.6e-7 of the coordinates apart.
    Through BN over three samples that sets the view and joints critics'
    gradients at parity 0 1.9e-4 apart (held within 5e-4), and the base's at
    parity 1, where those terms are the generator's, 1.4e-5 apart (held
    within 5e-5). Without them the base is 2.1e-7 apart."""
    with jax.enable_x64():
        jstep, jstates, batch, jcfg, cfg = _setup(rng, jnp.float64, WATCH_GRAD_NORM=False,
                                                  USE_FUNDAMENTAL_LOSS=False)
        key = jax.random.PRNGKey(4)
        b64 = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        new_j, jm = jstep(jstates, b64, key, epoch_parity=parity)
        new_j = _np(new_j)
        draws = jax_draws(key, batch, jcfg, parity)
        step, states = _port(cfg, jstates, torch.float64)
    b64 = {k: np.asarray(v, np.float64) for k, v in batch.items()}
    _, m = step(states, b64, parity, draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    for n, st in states.items():
        g = _jax_grads(n, st.params, new_j[n])
        gmax = max(float(v.abs().max()) for v in g.values())
        if n in ("view_discriminator", "joints_discriminator") and parity == 0:
            bound = 5e-4
        elif n == "base_model" and parity == 1:
            bound = 5e-5
        else:
            bound = 1e-6
        for k, p in st.params.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            err = float((got - g[k]).abs().max())
            scale = float(g[k].abs().max())
            if scale <= 1e-6 * gmax:  # no loss here, or rounding noise
                assert err <= 1e-6 * gmax, (n, k, err, gmax)
            else:
                assert err <= bound * scale, (n, k, err / scale)
