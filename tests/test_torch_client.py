"""Local SGD of the port against the reference on the CPU, with the
reference's epoch permutations injected (derived from the training key
exactly as ``repro.core.client.local_train_impl`` draws them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as ref_client
from repro.models.mlp_net import init_mlp
from repro_torch.core import client as port_client
from repro_torch.params import from_numpy

from _torch_parity import epoch_perms, np_tree

FEATS = (48, 16, 8, 1)


@pytest.mark.parametrize("epochs,batch", [(1, 32), (2, 50)])
def test_local_train_matches_reference(epochs, batch):
    rng = np.random.default_rng(0)
    x = (rng.random((230, FEATS[0])) < 0.15).astype(np.float32)
    y = (rng.random(230) < 0.4).astype(np.float32)
    p0 = np_tree(init_mlp(FEATS, jax.random.PRNGKey(1)))
    key = jax.random.PRNGKey(7)
    want = ref_client.local_train(p0, jnp.asarray(x), jnp.asarray(y), 0.05,
                                  key, batch_size=batch, epochs=epochs)
    got = port_client.local_train_impl(
        from_numpy(p0, "cpu"), torch.from_numpy(x), torch.from_numpy(y),
        0.05, perms=epoch_perms(key, x.shape[0], epochs),
        batch_size=batch, epochs=epochs)
    for lg, lw in zip(np_tree(got), np_tree(want)):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-5, rtol=0)
    # the delta is the paper's G = W_after - W_before, leaf by leaf
    g = port_client.client_delta(from_numpy(p0, "cpu"), got)
    for lg, la, lb in zip(np_tree(g), np_tree(got), p0):
        for k in lg:
            np.testing.assert_array_equal(lg[k], la[k] - lb[k])


def test_local_train_draws_on_generator_without_perms():
    x = torch.rand(64, FEATS[0])
    y = (torch.rand(64) < 0.5).float()
    p0 = from_numpy(np_tree(init_mlp(FEATS, jax.random.PRNGKey(0))), "cpu")
    a = port_client.local_train_impl(p0, x, y, 0.1,
                                     generator=torch.Generator().manual_seed(3),
                                     batch_size=16)
    b = port_client.local_train_impl(p0, x, y, 0.1,
                                     generator=torch.Generator().manual_seed(3),
                                     batch_size=16)
    assert all(torch.equal(la[k], lb[k]) for la, lb in zip(a, b) for k in la)
    # the caller's weights are untouched (the trainer works on a copy)
    assert not torch.equal(a[0]["w"], p0[0]["w"])
    with pytest.raises(ValueError):
        port_client.local_train_impl(p0, x, y, 0.1, batch_size=16)
