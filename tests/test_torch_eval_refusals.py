"""The port's ``cli test`` and ``cli serve`` refusals and default device,
on the CPU (beside tests/test_torch_eval.py; a file of 8 or fewer
tests queues behind the suite's longest file under ``--dist loadfile``):
a reference checkpoint for the ``tpu_decoder`` variant, serving layouts
that need more ranks or are training's, JAX StableHLO and missing
artifacts, each refused in one line with exit code 2; without a card the
default device raises.
"""

import pytest
import torch

from camradepth_tpu_torch import cli
from tests.test_torch_eval import TINY_FLAGS, corpus  # noqa: F401
from tests.torch_port import one_torch_thread  # noqa: F401


def test_cli_tpu_decoder_refuses_a_reference_checkpoint(corpus, capsys):
    _, split, pth = corpus
    for command in ("test", "serve"):
        rc = cli.main([command, "--tpu-decoder", "--split", str(split),
                       "--checkpoint", str(pth), "--device", "cpu"]
                      + TINY_FLAGS)
        err = capsys.readouterr().err.strip()
        assert rc == 2 and "tpu_decoder variant" in err, err
        assert err.startswith("error:") and "\n" not in err


# serving on a mesh needs a rank per share (cli serve on one process has
# one), and a mesh.* layout is training's: each refused in one line
@pytest.mark.parametrize("extra,item", [
    (["--http-port", "0", "--data-parallel", "2"], "needs 2 ranks, have 1"),
    (["--set", "mesh.spatial_parallel=2"], "--spatial-parallel"),
    (["--data-parallel", "2"], "needs 2 ranks, have 1"),
    (["--spatial-parallel", "2"], "needs 2 ranks, have 1"),
    (["--set", "mesh.data_parallel=2"], "mesh.* layout"),
])
def test_cli_refuses_options_of_later_slices(corpus, capsys, extra, item):
    _, split, pth = corpus
    rc = cli.main(["serve", "--split", str(split),
                   "--checkpoint", str(pth), "--device", "cpu"]
                  + TINY_FLAGS + extra)
    assert rc == 2
    assert item in capsys.readouterr().err


def test_cli_refuses_artifact_checkpoints(capsys, tmp_path):
    """A StableHLO artifact of the JAX package is refused in one line (the
    port serves its own artifacts, tests/test_torch_export.py), and so is
    a missing one."""
    jax_artifact = tmp_path / "model.hlo"
    jax_artifact.write_bytes(b"CRDSHLO1" + bytes(8))
    for path, match in ((jax_artifact, "JAX StableHLO artifact"),
                        (tmp_path / "missing.hlo", "No such file")):
        assert cli.main(["test", "--checkpoint", str(path),
                         "--device", "cpu"]) == 2
        err = capsys.readouterr().err.strip()
        assert match in err and "\n" not in err, err


def test_cli_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, split, pth = corpus
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["test", "--split", str(split),
                  "--checkpoint", str(pth)] + TINY_FLAGS)
