"""The port's model against the committed reference goldens and the JAX
package's golden synthesis and key converter, on the CPU (beside
tests/test_torch_model.py; a file of 8 or fewer tests queues behind the
suite's longest file under ``--dist loadfile``). Tolerances: those of
tests/test_flagship_golden.py:104-154,
tests/test_flagship_golden_fullres.py:42-45 and
tests/test_tpu_decoder_golden.py:76-79; the synthesized parameters and the
converted state_dict bit for bit.
"""

import dataclasses

import jax
import numpy as np
import torch

from camradepth_tpu.interop import golden as jax_golden
from camradepth_tpu.interop.torch_convert import flax_params_to_state_dict
from camradepth_tpu_torch.config import ModelConfig, preset
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.interop.golden import (
    flax_param_shapes,
    golden_input,
    synth_flax_params,
    synth_state_values,
)
from camradepth_tpu_torch.models.camradepth import create_model
from tests.test_torch_model import SMALL, _golden, small_jax_model  # noqa: F401
from tests.torch_port import one_torch_thread  # noqa: F401


def test_state_dict_from_flax_matches_jax_converter(small_jax_model):
    _, params = small_jax_model
    want = flax_params_to_state_dict(params)
    got = state_dict_from_flax(params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_state_dict_loads_strictly_into_port(small_jax_model):
    _, params = small_jax_model
    sd = state_dict_from_flax(params)
    model = create_model(ModelConfig(**SMALL, compute_dtype="float32"),
                         device="cpu", state_dict=sd)
    assert sorted(model.state_dict()) == sorted(sd)


def _golden_forward(golden, hw, name="base", state_dict=None, **kw):
    cfg = dataclasses.replace(preset(name).model, img_size=hw,
                              compute_dtype="float32", **kw)
    if state_dict is None:
        state_dict = synth_state_values(golden["shapes"])
    model = create_model(cfg, device="cpu", state_dict=state_dict)
    with torch.no_grad():
        return model(torch.from_numpy(golden_input(hw)))


def test_port_matches_committed_golden_128x256():
    """The base preset's full depths (3,10,16,5) and widths at 128x256,
    reference weights synthesized from the committed shape table."""
    golden = _golden("flagship_128x256.npz")
    out = _golden_forward(golden, (128, 256))
    np.testing.assert_allclose(out["depth"]["final_depth"].numpy(),
                               golden["final_depth"], rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][2].numpy(),
                               golden["inter2"], rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][3].numpy(),
                               golden["inter3"], rtol=2e-3, atol=5e-4)


def test_port_matches_committed_golden_416x800():
    """The shipping geometry (fp16 maps plus an fp32 crop anchor)."""
    golden = _golden("flagship_416x800.npz")
    out = _golden_forward(golden, (416, 800))
    final = out["depth"]["final_depth"].numpy()
    cy, cx = golden["crop_yx"]
    np.testing.assert_allclose(final[:, cy:cy + 64, cx:cx + 128],
                               golden["final_depth_crop"], rtol=2e-3,
                               atol=5e-4)
    np.testing.assert_allclose(final,
                               golden["final_depth_f16"].astype(np.float32),
                               rtol=2e-3, atol=1.5e-3)
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][2].numpy(),
                               golden["inter2"], rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(
        out["depth"]["intermediate_depths"][3].numpy(),
        golden["inter3_f16"].astype(np.float32), rtol=2e-3, atol=1.5e-3)


def test_port_matches_committed_seg_golden_128x256():
    """sup_unsup_seg at the full depths and widths at 128x256, reference
    weights synthesized from the committed shape table, with the limits
    of tests/test_flagship_golden.py:118-154: the depth heads read the
    argmax guidance maps, so a flipped near-tie pixel moves depth near
    it."""
    golden = _golden("flagship_seg_128x256.npz")
    out = _golden_forward(golden, (128, 256), "sup_unsup_seg")
    seg = out["seg"]["final_seg"].numpy()
    cy, cx = golden["crop_yx"]
    np.testing.assert_allclose(seg[:, cy:cy + 32, cx:cx + 64],
                               golden["final_seg_crop"], rtol=2e-3,
                               atol=1e-3)
    flips = seg.argmax(-1) != golden["final_seg_argmax"]
    assert flips.mean() < 0.005, flips.mean()
    unsup = out["seg"]["unsup_map"].numpy() == golden["unsup_map"]
    assert unsup.mean() > 0.995, unsup.mean()
    got = out["depth"]["final_depth"].numpy()[0, ..., 0]
    want = golden["final_depth"][0, ..., 0]
    err = np.abs(got - want)
    assert (err <= 5e-4 + 2e-3 * np.abs(want)).mean() > 0.995
    assert np.median(err) < 2e-4 and err.max() < 0.2
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][2].numpy(),
                               golden["inter2"], rtol=2e-3, atol=5e-4)


def test_port_matches_committed_tpu_decoder_golden_128x256():
    """base with tpu_decoder at the full depths and widths at 128x256:
    flax parameters synthesized by the port's own golden copy from the
    committed flax shape table, carried by state_dict_from_flax."""
    golden = _golden("tpu_decoder_128x256.npz")
    sd = state_dict_from_flax(synth_flax_params(golden["shapes"]))
    out = _golden_forward(golden, (128, 256), state_dict=sd,
                          tpu_decoder=True)
    d = out["depth"]
    for key, got in (("final_depth", d["final_depth"]),
                     ("inter_depth_3", d["intermediate_depths"][2]),
                     ("inter_depth_4", d["intermediate_depths"][3])):
        np.testing.assert_allclose(got.numpy(), golden[key], rtol=5e-4,
                                   atol=5e-6, err_msg=key)


def test_golden_synthesis_matches_jax_package():
    """The port's flax_param_shapes and synth_flax_params give the JAX
    package's shape table and values bit for bit, from the tpu_decoder
    golden's table."""
    shapes = _golden("tpu_decoder_128x256.npz")["shapes"]
    want = jax_golden.synth_flax_params(shapes)
    got = synth_flax_params(shapes)
    assert flax_param_shapes(got) == jax_golden.flax_param_shapes(want) == (
        shapes)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_want) == len(shapes)
    for path, w in flat_want:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_array_equal(g, w)
