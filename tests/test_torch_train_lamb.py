"""The train-state bridge for lamb (``weights.train_state_from_flax`` and
``flax_adam_state_from_port``): the JAX package's lamb chain (clip 5, weight
decay) runs two updates on the resnet50 DAD-3DNet's parameter tree; its
optimizer state, handed over as optax keeps it, starts the port's ``Lamb``,
and a third update on the same gradients agrees leaf by leaf: each port
parameter is one flax leaf, so the trust ratio's norms are the same. On the
card, one lamb update against the CPU's from one state. JAX is imported only
inside the CPU test: the card test runs from this file."""

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.models import create_model
from dad3dheads_tpu_torch.train import get_optimizer

LAMB = {"name": "lamb", "lr": 1e-3, "weight_decay": 1e-2}
CLIP = 5.0


def _grads(rng, params):
    """A gradient tree like ``params`` (flax layout), of norm well above the
    clip."""
    return {k: _grads(rng, v) if isinstance(v, dict) else rng.normal(size=v.shape).astype(np.float32) * 0.01
            for k, v in params.items()}


def _set_grads(model, grads, batch_stats):
    tensors = weights.state_dict_from_flax({"params": grads, "batch_stats": batch_stats})
    for name, p in model.named_parameters():
        p.grad = tensors[name].clone()


def test_lamb_state_bridge_continues_the_jax_chain():
    import jax
    import jax.numpy as jnp
    import optax

    from dad3dheads_tpu.train.optimizers import get_optimizer as jax_get_optimizer

    model = create_model({}, torch.Generator().manual_seed(0))
    variables = weights.flax_from_state_dict(model.state_dict())
    rng = np.random.default_rng(3)
    tx = jax_get_optimizer(dict(LAMB), gradient_clip_val=CLIP)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = jax.jit(tx.init)(params)
    grads = [_grads(rng, variables["params"]) for _ in range(3)]

    @jax.jit
    def update(g, opt_state, params):  # one program, not one dispatch per leaf and op
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for g in grads[:2]:
        params, opt_state = update(g, opt_state, params)
    start = {"params": jax.tree_util.tree_map(np.asarray, params), "batch_stats": variables["batch_stats"]}

    port = model  # the bridge replaces every weight
    opt = get_optimizer(dict(LAMB), port.parameters(), gradient_clip_val=CLIP)
    weights.train_state_from_flax(start, opt_state, port, opt.optimizer)  # the optax state as it is
    moments = weights.adam_moments(opt_state)
    back = weights.flax_adam_state_from_port(opt.optimizer.state_dict()["state"], port)
    assert back["count"] == moments["count"] == 2
    for name in ("mu", "nu"):
        ref, out = weights._flatten(moments[name]), weights._flatten(back[name])
        assert set(ref) == set(out)
        assert all(np.array_equal(out[k], ref[k]) for k in ref), name

    params, opt_state = update(grads[2], opt_state, params)
    _set_grads(port, grads[2], variables["batch_stats"])
    opt.step(1.0)
    ref = weights._flatten({"params": jax.tree_util.tree_map(np.asarray, params)})
    out = weights._flatten(weights.flax_from_state_dict(port.state_dict()))
    moved = max(float(np.abs(ref[k] - start_k).max()) for k, start_k in weights._flatten(
        {"params": start["params"]}).items())
    assert moved > 1e-4  # the update is larger than the tolerance
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, rtol=0, atol=1e-6, err_msg=k)


def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_lamb_update_matches_the_cpu():
    """Two clipped lamb updates of the resnet50's parameters from one seeded
    state and gradients, card against CPU: within 1e-6 (the norms and the
    moments sum in another order)."""
    dev = cuda()
    runs = []
    for device in ("cpu", dev):
        model = create_model({}, torch.Generator().manual_seed(0)).to(device)
        opt = get_optimizer(dict(LAMB), model.parameters(), gradient_clip_val=CLIP)
        gen = torch.Generator().manual_seed(4)
        for _ in range(2):
            for p in model.parameters():
                p.grad = (torch.randn(p.shape, generator=gen) * 0.01).to(device)
            opt.step(1.0)
        runs.append({k: v.detach().cpu() for k, v in model.named_parameters()})
    for k, v in runs[0].items():
        torch.testing.assert_close(runs[1][k], v, rtol=0, atol=1e-6)
