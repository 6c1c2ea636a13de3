"""The port's encoder block, patch embedding, decoder stage and depth head
against the flax modules of the JAX package, on the CPU, in fp32: 1e-4
(the two frameworks sum convs and dots in other orders; errors stay near
1e-6 per op) (beside tests/test_torch_model.py; a file of 8 or fewer tests
queues behind the suite's longest file under ``--dist loadfile``). Flax
parameter trees come across through the port's ``state_dict_from_flax``;
inputs are numpy-seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.models import encoder as jenc
from camradepth_tpu.models import layers as jlay
from camradepth_tpu_torch.models import encoder as tenc
from camradepth_tpu_torch.models import layers as tlay
from tests.test_torch_model import _carry, _jax_init, _rand
from tests.torch_port import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dim,heads,ratio,sr,hw", [
    (16, 1, 2, 8, (16, 32)), (32, 2, 4, 4, (8, 16)), (64, 8, 4, 1, (2, 4)),
])
def test_block_matches_flax(dim, heads, ratio, sr, hw):
    jmod = jenc.Block(dim, heads, mlp_ratio=ratio, sr_ratio=sr,
                      dtype=jnp.float32)
    x = _rand((2, hw[0] * hw[1], dim), 10)
    params = _jax_init(jmod, jnp.asarray(x), hw)
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v, hw))(
        params, jnp.asarray(x)))
    port = _carry(tenc.Block(dim, heads, ratio, sr), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_ch,feat,patch,stride", [(7, 16, 7, 4),
                                                     (16, 32, 3, 2)])
def test_overlap_patch_embed_matches_flax(in_ch, feat, patch, stride):
    jmod = jenc.OverlapPatchEmbed(feat, patch, stride, dtype=jnp.float32)
    x = _rand((2, 20, 36, in_ch), 11)
    params = _jax_init(jmod, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    port = _carry(tenc.OverlapPatchEmbed(in_ch, feat, patch, stride), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_ch,skip_ch", [(33, 0), (32, 7)])
def test_decoder_matches_flax(in_ch, skip_ch):
    jmod = jlay.Decoder(32, has_skip=bool(skip_ch), dtype=jnp.float32)
    x = _rand((2, 5, 9, in_ch), 12)
    args = [jnp.asarray(x)]
    skip = None
    if skip_ch:
        skip = _rand((2, 10, 18, skip_ch), 13)
        args.append(jnp.asarray(skip))
    params = _jax_init(jmod, *args)
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, *args))
    port = _carry(tlay.Decoder(in_ch, 32, skip_ch), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if skip is None else torch.from_numpy(skip)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_depth_activation_matches_flax():
    jmod = jlay.DepthActivation(1, dtype=jnp.float32)
    x = _rand((2, 12, 20, 33), 14)
    params = _jax_init(jmod, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    port = _carry(tlay.DepthActivation(33), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
