"""The port's DepthEngine (camradepth_tpu_torch.serving) against the JAX
DepthEngine on carried weights and the same frames, on the CPU.

The model agrees with the JAX one to 1e-4 in fp32 (tests/test_torch_model.py);
depth is decoded to metres as 100 * (1 - d), so the depth maps are held to
1e-2 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import ExperimentConfig as JaxExperimentConfig
from camradepth_tpu.config import ModelConfig as JaxModelConfig
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu.serving import DepthEngine as JaxDepthEngine
from camradepth_tpu_torch.config import ExperimentConfig, ModelConfig
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.serving import DepthEngine, load_engine
from tests.torch_port import one_torch_thread  # noqa: F401

SMALL = dict(
    img_size=(64, 128), dims=(16, 32, 32, 64), heads=(1, 2, 4, 8),
    ff_expansion=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1), depths=(1, 1, 1, 1),
    mid_channels=32, input_channels=7, drop_path_rate=0.0,
    compute_dtype="float32",
)
H, W = SMALL["img_size"]


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**SMALL))
    jmodel = JaxCamRaDepth(jcfg.model)
    shapes = jax.eval_shape(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((1, H, W, 7)), deterministic=True),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):  # numpy-seeded values in the init's shapes
        g = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.1 * g
        if name == "bias":
            return 0.1 * g
        return g / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    cfg = ExperimentConfig(model=ModelConfig(**SMALL))
    model = create_model(cfg.model, device="cpu",
                         state_dict=state_dict_from_flax(params))
    return (JaxDepthEngine(jcfg, jmodel, params, batch_size=4),
            DepthEngine(cfg, model, batch_size=4, device="cpu"))


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((H, W, 7)).astype(np.float32)
            for _ in range(n)]


def test_tail_batch_matches_jax(engines):
    jeng, eng = engines
    x = np.stack(_frames(3, 0))  # a ragged batch: padded inside
    want = jeng.infer_batch(x)
    got = eng.infer_batch(x)
    assert got.keys() == want.keys() == {"depth"}
    assert got["depth"].shape == (3, H, W)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=0,
                               atol=1e-2)
    assert 0.0 <= got["depth"].min() and got["depth"].max() <= 100.0


def test_stream_matches_jax_in_order(engines):
    jeng, eng = engines
    frames = _frames(7, 1)  # one full batch of 4 and a tail of 3
    items = [np.stack(frames[:4]), frames[4], frames[5], frames[6]]
    want = list(jeng.infer_stream(iter(frames)))
    for inflight in (1, 2):
        got = list(eng.infer_stream(iter(items), inflight=inflight))
        assert len(got) == 7
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            np.testing.assert_allclose(g["depth"], w["depth"], rtol=0,
                                       atol=1e-2)
    # order: frame i of the stream is frame i served alone
    single = eng.infer_batch(frames[5][None])
    np.testing.assert_array_equal(got[5]["depth"], single["depth"][0])


def test_stats_keys_match_jax(engines):
    jeng, eng = engines
    for e in engines:
        e.reset_stats()
        e.infer_batch(np.stack(_frames(2, 2)))
    got, want = eng.stats(), jeng.stats()
    assert got.keys() == want.keys()
    assert got["frames"] == want["frames"] == 2.0
    assert got["batches"] == 1.0 and got["frames_per_sec"] > 0


def test_stream_raises_what_the_source_raises(engines):
    _, eng = engines

    def source():
        yield _frames(1, 3)[0]
        raise KeyError("bad frame")

    with pytest.raises(KeyError, match="bad frame"):
        list(eng.infer_stream(source()))


def test_load_engine_serves_a_reference_checkpoint(engines, tmp_path):
    """A reference-format .pth (``{"state_dict": ...}`` with DataParallel
    prefixes) loads strictly and serves the same depth."""
    _, eng = engines
    sd = {"module." + k: v for k, v in eng.model.state_dict().items()}
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": sd}, path)
    cfg = ExperimentConfig(model=ModelConfig(**SMALL))
    loaded = load_engine(cfg, str(path), batch_size=4, device="cpu")
    x = np.stack(_frames(4, 4))
    np.testing.assert_array_equal(loaded.infer_batch(x)["depth"],
                                  eng.infer_batch(x)["depth"])
