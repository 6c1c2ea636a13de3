"""The port's split tools, ``cli validate-data`` and learnable synthetic
scenes against the JAX package's, on the CPU.

One 4-frame 32x64 corpus with a fault planted in each frame: an ``im_uv``
of the wrong dtype, a ``rad_vel`` that is missing while a stray one of a
fifth stem stands in its place (so the sorted-glob zip shifts the column
of every later row), a ``radar`` of the wrong shape, and a negative GT
depth. ``validate_split`` (on the generator's table, on the globbed one,
with a limit, without the decode, and past the 50-error cap),
``build_split_from_dir`` (and its two refusals), ``rebase_split`` and
``cli validate-data`` (exit codes 0, 1 and 2, and every printed line) give
the JAX package's results. ``generate(scene=True)`` writes the JAX
package's corpus from the same seed: every ``.npy`` bit for bit, the same
decoded jpgs, the same split table.
"""

import contextlib
import io
import shutil

import cv2
import numpy as np
import pytest

from camradepth_tpu import cli as jax_cli
from camradepth_tpu.data import split as jax_split
from camradepth_tpu.data import synthetic as jax_synthetic
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.data import split, synthetic

HW = (32, 64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(clean dir and its split, faulty dir and its split)."""
    tmp = tmp_path_factory.mktemp("data")
    clean = synthetic.generate(tmp / "clean", num_frames=4, hw=HW, seed=1)
    faulty = tmp / "faulty"
    shutil.copytree(tmp / "clean", faulty)
    np.save(faulty / "00000_im_uv.npy",
            np.zeros(HW + (2,), np.int32))
    (faulty / "00001_rad_vel.npy").unlink()
    np.save(faulty / "00004_rad_vel.npy", np.zeros(HW, np.float32))
    np.save(faulty / "00002_radar.npy", np.zeros(HW + (2,), np.float32))
    gt = np.load(faulty / "00003_rain_gt.npy")
    gt[3, 5, 0] = -2.0
    np.save(faulty / "00003_rain_gt.npy", gt)
    table = np.array([[p.replace(str(tmp / "clean"), str(faulty))
                       for p in row] for row in np.load(clean)])
    faulty_split = split.save_split(table, tmp / "faulty_split.npy")
    return tmp / "clean", clean, faulty, faulty_split


def test_build_split_from_dir_matches_jax(corpus, tmp_path):
    clean_dir, clean_split, faulty_dir, _ = corpus
    for d in (clean_dir, faulty_dir):
        got = split.build_split_from_dir(d)
        np.testing.assert_array_equal(got, jax_split.build_split_from_dir(d))
    np.testing.assert_array_equal(split.build_split_from_dir(clean_dir),
                                  np.load(clean_split))
    # the refusals: no images; fewer files of a type than images
    short = tmp_path / "short"
    shutil.copytree(clean_dir, short)
    (short / "00002_gt.npy").unlink()
    for d, exc in ((tmp_path, FileNotFoundError), (short, ValueError)):
        with pytest.raises(exc) as ours:
            split.build_split_from_dir(d)
        with pytest.raises(exc) as theirs:
            jax_split.build_split_from_dir(d)
        assert str(ours.value) == str(theirs.value)


def test_rebase_split_matches_jax(corpus):
    rows = np.load(corpus[1])
    np.testing.assert_array_equal(split.rebase_split(rows, "/data/x"),
                                  jax_split.rebase_split(rows, "/data/x"))


@pytest.mark.parametrize("table", ["clean", "faulty", "globbed", "limit",
                                   "no_decode", "capped"])
def test_validate_split_matches_jax(corpus, table):
    _, clean_split, faulty_dir, faulty_split = corpus
    kw = dict(image_dimension=HW)
    rows = split.load_split(faulty_split)
    if table == "clean":
        rows = split.load_split(clean_split)
    elif table == "globbed":
        rows = split.build_split_from_dir(faulty_dir)
    elif table == "limit":
        kw["limit"] = 2
    elif table == "no_decode":
        kw["decode_images"] = False
    elif table == "capped":
        rows = np.concatenate([split.build_split_from_dir(faulty_dir)] * 10)
        kw["decode_images"] = False
    got = split.validate_split(rows, **kw)
    assert got == jax_split.validate_split(rows, **kw)
    assert got["ok"] == (table == "clean")
    if table == "capped":
        assert len(got["errors"]) == 50
    if table == "globbed":  # the stem check names the shifted rows
        assert [i for i, m in got["errors"] if "misaligned" in m] == [1, 2, 3]


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("args", ["clean", "faulty", "dir", "capped",
                                  "neither", "both"])
def test_cli_validate_data_matches_jax(corpus, tmp_path, args):
    clean_dir, clean_split, faulty_dir, faulty_split = corpus
    argv = {
        "clean": ["--split", str(clean_split)],
        "faulty": ["--split", str(faulty_split), "--limit", "3"],
        "dir": ["--data-dir", str(faulty_dir), "--no-decode"],
        "neither": [],
        "both": ["--split", str(clean_split), "--data-dir", str(clean_dir)],
    }.get(args)
    if args == "capped":
        rows = np.concatenate([split.load_split(faulty_split)] * 15)
        argv = ["--split", str(split.save_split(rows, tmp_path / "x.npy"))]
    argv = ["validate-data", "--image-dimension", "32,64"] + argv
    got = run(cli.main, argv)
    assert got == run(jax_cli.main, argv)
    assert got[0] == {"clean": 0, "neither": 2, "both": 2}.get(args, 1)
    if args == "capped":
        assert got[1].endswith("50 errors (further errors suppressed)\n")


def test_scene_corpus_matches_jax(tmp_path):
    ours = synthetic.generate(tmp_path / "port", num_frames=4, hw=HW,
                              seed=2, scene=True)
    theirs = jax_synthetic.generate(tmp_path / "jax", num_frames=4, hw=HW,
                                    seed=2, scene=True)
    rows, want = np.load(ours), np.load(theirs)
    assert rows.shape == want.shape == (4, 7)
    for row, wrow in zip(rows, want):
        for p, q in zip(row, wrow):
            assert p.split("/")[-1] == q.split("/")[-1]
            if p.endswith(".npy"):
                a, b = np.load(p), np.load(q)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=p)
            else:
                np.testing.assert_array_equal(cv2.imread(p), cv2.imread(q))
    # a scene, not noise: depth and appearance agree (nearer is brighter)
    gt = np.load(rows[0][6])[..., 0]
    grey = cv2.imread(rows[0][0]).mean(-1)
    valid = gt > 0
    assert np.corrcoef(gt[valid], grey[valid])[0, 1] < -0.5
