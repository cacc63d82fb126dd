"""The port's image data layer (data/{base,zipreader,mpii,coco,mixed,
registry,loader,prepare}.py, utils/vis.py, MultiViewH36M.evaluate's
drawings) against the JAX package on the CPU, on small on-disk fixtures
that both packages read: MPII and H36M from data/synthetic.write_image_fixture
(96x72 and 120x120 JPEGs, in a zip and as files), and a COCO annotation
file written here.

The JAX side runs its Python image path (``POSETPU_NATIVE_LOADER=0``), so no
test touches ``posetpu.native``. Records and batches, with the augmentation
and the colour jitter on, are equal bit for bit: uint8 crops, crop joints,
visibility, center, scale, rotation, supervise, subject. The drawings are
held within one grey level (cv2 draws and encodes alike in both)."""

from __future__ import annotations

import json
import os
import shutil
import zipfile

import cv2
import jax
import numpy as np
import pytest
import torch

from posetpu.config import default_config as jax_config
from posetpu.data import base as jbase
from posetpu.data import loader as jloader
from posetpu.data import registry as jregistry
from posetpu.data import zipreader as jzip
from posetpu.data.prepare import make_prepare_fn as jax_prepare_fn
from posetpu.utils import vis as jvis
from posetpu_torch.config import default_config
from posetpu_torch.data import base as tbase
from posetpu_torch.data import loader as tloader
from posetpu_torch.data import registry as tregistry
from posetpu_torch.data import zipreader as tzip
from posetpu_torch.data.prepare import make_prepare_fn
from posetpu_torch.data.synthetic import write_image_fixture
from posetpu_torch.utils import vis as tvis

NAMES = ["mpii", "coco", "coco_mpii", "multiview_h36m", "mixed"]
BATCH_KEYS = ("images", "joints_crop", "joints_vis", "supervise", "center", "scale",
              "rotation", "joints_2d", "is_h36m", "subject")


def write_coco(root, n_images=6, size=(90, 70), seed=3):
    """coco/annotations/person_keypoints_train2017.json and its JPEGs
    (two people on some images, one crowd annotation, one without
    keypoints: both skipped by the loaders)."""
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, "coco", "images", "train2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "coco", "annotations"), exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name),
                    rs.randint(0, 255, (size[1], size[0], 3)).astype(np.uint8))
        images.append({"id": 100 + i, "file_name": name})
        for p in range(1 + i % 2):
            kp = np.concatenate([rs.uniform(5, 65, (17, 2)),
                                 rs.randint(0, 3, (17, 1))], 1)
            x, y = rs.uniform(0, 30, 2)
            anns.append({"image_id": 100 + i, "keypoints": kp.ravel().tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum()),
                         "bbox": [x, y, rs.uniform(20, 50), rs.uniform(20, 60)],
                         "iscrowd": int(i == 2 and p == 1)})
    anns.append({"image_id": 100, "keypoints": [0] * 51, "num_keypoints": 0,
                 "bbox": [1, 1, 5, 5], "iscrowd": 0})
    with open(os.path.join(root, "coco", "annotations", "person_keypoints_train2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def write_fixture(root, data_format="zip"):
    write_image_fixture(str(root), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=24, mpii_valid=16, h36m_train_groups=3, h36m_valid_groups=2,
                        data_format=data_format, seed=5)
    write_coco(str(root))
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"zip": root, "jpg": root}: the same fixture in both layouts."""
    return {fmt: write_fixture(tmp_path_factory.mktemp(fmt), fmt) for fmt in ("zip", "jpg")}


def cfgs(root, data_format="zip", jitter=True, **over):
    """(JAX config, port config) at 64x64 crops and 16x16 maps, every
    source's augmentation on."""
    out = []
    for make in (jax_config, default_config):
        c = make()
        c.DATASET.ROOT = str(root)
        c.DATASET.DATA_FORMAT = data_format
        c.DATASET.COLOR_JITTER = jitter
        c.NETWORK.IMAGE_SIZE = np.array([64, 64])
        c.NETWORK.HEATMAP_SIZE = np.array([16, 16])
        for src, (sf, rf) in {"MPII": (0.25, 30), "COCO": (0.35, 40), "H36M": (0.2, 20)}.items():
            setattr(c.DATASET, f"{src}_SCALE_FACTOR", sf)
            setattr(c.DATASET, f"{src}_ROT_FACTOR", rf)
            setattr(c.DATASET, f"{src}_FLIP", True)
        for k, v in over.items():
            sec, key = k.split(".")
            setattr(getattr(c, sec), key, v)
        out.append(c)
    return out


def datasets(name, root, monkeypatch, subset="train", is_train=True, data_format="zip",
             jitter=True, **over):
    """(JAX data set on its Python image path, the port's)."""
    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    jcfg, tcfg = cfgs(root, data_format, jitter, **over)
    jds = jregistry.get_dataset(name)(jcfg, subset, is_train)
    tds = tregistry.get_dataset(name)(tcfg, subset, is_train)
    assert not jds.use_native_loader
    return jds, tds


def epochs_of(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.extend(loader)
    return out


def assert_batches_equal(got, ref):
    assert len(got) == len(ref) and len(ref) > 0
    for b, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r) == set(BATCH_KEYS), (set(g), set(r))
        for k in BATCH_KEYS:
            assert g[k].dtype == r[k].dtype, (b, k, g[k].dtype, r[k].dtype)
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"batch {b} {k}")


# ------------------------------------------------------------- records


@pytest.mark.parametrize("name", NAMES)
def test_batches_bit_equal_to_jax(roots, monkeypatch, name):
    """Two epochs of batches with the augmentation and the jitter on."""
    jds, tds = datasets(name, roots["zip"], monkeypatch)
    assert len(tds) == len(jds) > 1 and tds.grouping == jds.grouping
    ref = epochs_of(jloader.GroupLoader(jds, 2, seed=11, prefetch=0))
    got = epochs_of(tloader.GroupLoader(tds, 2, seed=11, prefetch=0))
    assert_batches_equal(got, ref)
    if name != "multiview_h36m":  # h36m takes no augmentation
        assert np.any(np.concatenate([b["rotation"] for b in got]) != 0)


@pytest.mark.parametrize("name", ["mpii", "multiview_h36m"])
def test_plain_files_read_as_the_zip_and_as_jax(roots, monkeypatch, name):
    """DATA_FORMAT jpg: the same bytes as JAX's (cv2.imread there,
    imdecode of the file's bytes here) and as the zip fixture's."""
    jds, tds = datasets(name, roots["jpg"], monkeypatch, data_format="jpg")
    got = epochs_of(tloader.GroupLoader(tds, 2, seed=4, prefetch=0), (0,))
    assert_batches_equal(got, epochs_of(jloader.GroupLoader(jds, 2, seed=4, prefetch=0), (0,)))
    _, zds = datasets(name, roots["zip"], monkeypatch)
    assert_batches_equal(got, epochs_of(tloader.GroupLoader(zds, 2, seed=4, prefetch=0), (0,)))


@pytest.mark.parametrize("defer", [False, True])
def test_records_bit_equal_to_jax_and_draws_in_its_order(roots, monkeypatch, defer):
    """load_group with and without deferring the image: the record and the
    parent stream's next draw as JAX's."""
    jds, tds = datasets("coco_mpii", roots["zip"], monkeypatch)
    for g in range(len(tds)):
        jrs, trs = np.random.RandomState(g), np.random.RandomState(g)
        ref = jds.load_group(g, jrs, defer_images=defer)
        got = tds.load_group(g, trs, defer_images=defer)
        if defer:
            assert all("_image_job" in v and "image" not in v for v in got)
            tloader.GroupLoader(tds, 1)._run_image_jobs([got], None)
        assert jrs.randint(1 << 30) == trs.randint(1 << 30)
        for r, v in zip(ref, got):
            assert set(v) == set(r) and "_image_job" not in v
            for k in r:
                np.testing.assert_array_equal(v[k], r[k], err_msg=k)


def test_validation_records_take_no_augmentation(roots, monkeypatch):
    jds, tds = datasets("mpii", roots["zip"], monkeypatch, subset="valid", is_train=False,
                        jitter=False)
    got = epochs_of(tloader.GroupLoader(tds, 3, shuffle=False, drop_last=False, prefetch=0),
                    (0,))
    ref = epochs_of(jloader.GroupLoader(jds, 3, shuffle=False, drop_last=False, prefetch=0),
                    (0,))
    assert_batches_equal(got, ref)
    assert all(np.all(b["rotation"] == 0) for b in got)


def test_affine_matrix_and_colour_jitter_match_jax(rng):
    for _ in range(5):
        c, s, r = rng.uniform(0, 300, 2), rng.uniform(0.2, 3, 2), rng.uniform(-60, 60)
        np.testing.assert_array_equal(tbase._affine_matrix_np(c, s, r, (64, 48)),
                                      jbase._affine_matrix_np(c, s, r, (64, 48)))
    img = rng.randint(0, 256, (32, 40, 3)).astype(np.uint8)
    for seed in range(6):
        np.testing.assert_array_equal(
            tbase._color_jitter(img, np.random.RandomState(seed)),
            jbase._color_jitter(img, np.random.RandomState(seed)))


def test_zipreader_matches_jax(roots):
    root = str(roots["zip"])
    path = os.path.join(root, "mpii", "images.zip@", "images", "00001.jpg")
    assert tzip.split_zip_path(path) == jzip.split_zip_path(path)
    assert tzip.is_zip_path(path) and not tzip.is_zip_path("/a/b.jpg")
    flags = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
    np.testing.assert_array_equal(tzip.imread(path, flags), jzip.imread(path, flags))
    with pytest.raises(ValueError):
        tzip.split_zip_path("/a/b.jpg")
    with pytest.raises(FileNotFoundError, match="nothing.jpg"):
        tzip.imread(os.path.join(root, "mpii", "images.zip@", "images", "nothing.jpg"))


def test_collate_groups_matches_jax(roots, monkeypatch):
    jds, tds = datasets("mixed", roots["zip"], monkeypatch)
    groups = [g for g in (0, len(tds) - 1)]
    ref = jloader.collate_groups([jds.load_group(g, np.random.RandomState(g)) for g in groups])
    got = tloader.collate_groups([tds.load_group(g, np.random.RandomState(g)) for g in groups])
    assert_batches_equal([got], [ref])
    assert got["is_h36m"].tolist() == [1.0, 0.0] and got["supervise"].tolist() == [0.0, 1.0]


@pytest.mark.parametrize("name", NAMES)
def test_registry_serves_every_name(name):
    assert name in tregistry.DATASETS and set(tregistry.DATASETS) == set(jregistry.DATASETS)
    assert tregistry.get_dataset(name).__name__ == jregistry.get_dataset(name).__name__


# -------------------------------------------------------------- loader


@pytest.mark.parametrize("shards,index,drop_last", [(2, 0, True), (2, 1, False), (3, 2, True)])
def test_sharding_and_drop_last_match_jax(roots, monkeypatch, shards, index, drop_last):
    jds, tds = datasets("mixed", roots["zip"], monkeypatch)
    kw = dict(seed=2, num_shards=shards, shard_index=index, drop_last=drop_last, prefetch=0)
    jl, tl = jloader.GroupLoader(jds, 2, **kw), tloader.GroupLoader(tds, 2, **kw)
    for e in (0, 3):
        jl.set_epoch(e)
        tl.set_epoch(e)
        np.testing.assert_array_equal(tl._indices(), jl._indices())
        assert len(tl) == len(jl)
    assert_batches_equal(epochs_of(tl), epochs_of(jl))


def test_weighted_sampling_matches_jax(roots, monkeypatch):
    jds, tds = datasets("mixed", roots["zip"], monkeypatch, **{"DATASET.IF_SAMPLE": True})
    jcfg, tcfg = cfgs(roots["zip"])
    np.testing.assert_array_equal(tds.group_weights(tcfg), jds.group_weights(jcfg))
    jl = jloader.GroupLoader(jds, 2, seed=6, prefetch=0)
    tl = tloader.GroupLoader(tds, 2, seed=6, prefetch=0)
    jl.set_weights(jds.group_weights(jcfg))
    tl.set_weights(tds.group_weights(tcfg))
    assert_batches_equal(epochs_of(tl), epochs_of(jl))
    tl.set_weights(None)
    assert sorted(tl._indices().tolist()) == list(range(len(tds)))


def test_prefetch_and_thread_pool_equal_serial_loading(roots, monkeypatch):
    """prefetch 0 and 3, one thread and six: the same batches."""
    _, tds = datasets("coco_mpii", roots["zip"], monkeypatch)
    serial = epochs_of(tloader.GroupLoader(tds, 2, seed=9, prefetch=0, num_threads=1))
    for prefetch, threads in ((3, 1), (0, 6), (3, 6)):
        got = epochs_of(tloader.GroupLoader(tds, 2, seed=9, prefetch=prefetch,
                                            num_threads=threads))
        assert_batches_equal(got, serial)


def test_a_consumer_that_stops_early_stops_the_prefetch_thread(roots, monkeypatch):
    import threading

    _, tds = datasets("mpii", roots["zip"], monkeypatch)
    loader = tloader.GroupLoader(tds, 1, prefetch=1, num_threads=2)
    it = iter(loader)
    next(it)
    it.close()
    names = [t.name for t in threading.enumerate()]
    assert not any(n.startswith(("posetpu-prefetch", "posetpu-images")) for n in names), names


@pytest.mark.parametrize("prefetch", [0, 2])
def test_a_record_that_does_not_decode_raises_with_its_path(tmp_path, monkeypatch, prefetch):
    root = write_fixture(tmp_path / "bad", "jpg")
    bad = root / "mpii" / "images" / "00002.jpg"
    bad.write_bytes(b"not a jpeg")
    _, tds = datasets("mpii", root, monkeypatch, data_format="jpg")
    with pytest.raises(FileNotFoundError, match="00002.jpg"):
        list(tloader.GroupLoader(tds, 2, prefetch=prefetch, num_threads=3))


# -------------------------------------------------------------- prepare


def test_prepare_matches_jax(roots, monkeypatch):
    """Images: uint8 / 255, minus the mean, over the std in f32 on both
    sides; XLA may fold the division into a multiply, so within 2 ulp of
    the normalised range (~4.8e-7 a unit). Targets: equal where JAX's
    renders the same integer centres (the same formula in f32), within
    1e-6; weights and the rest equal."""
    jds, tds = datasets("mixed", roots["zip"], monkeypatch)
    host = next(iter(tloader.GroupLoader(tds, 3, seed=1, prefetch=0)))
    jcfg, tcfg = cfgs(roots["zip"])
    ref = jax.tree.map(np.asarray, jax_prepare_fn(jcfg)(host))
    got = make_prepare_fn(tcfg, device="cpu")(host)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k == "images":
            np.testing.assert_allclose(g, r, rtol=0, atol=2 * np.spacing(np.float32(2.7)))
        elif k == "target":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    sup = torch.from_numpy(host["supervise"]) > 0  # h36m without pseudo labels: weight 0
    assert 0 < int(sup.sum()) < len(sup)
    assert got["weight"][~sup].sum() == 0 and got["weight"][sup].sum() > 0


# --------------------------------------------------------------- vis


def _grey_close(a_path, b_path):
    a, b = cv2.imread(str(a_path)), cv2.imread(str(b_path))
    assert a is not None and a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("sheet", ["joints", "heatmaps", "debug"])
def test_vis_sheets_match_jax(tmp_path, rng, sheet):
    imgs = rng.randint(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    joints = rng.uniform(0, 32, (5, 16, 2)).astype(np.float32)
    vis = (rng.rand(5, 16) > 0.3).astype(np.float32)
    hms = rng.rand(5, 8, 8, 16).astype(np.float32)
    if sheet == "joints":
        tvis.save_batch_image_with_joints(imgs, joints, vis, str(tmp_path / "t.jpg"), nrow=2)
        jvis.save_batch_image_with_joints(imgs, joints, vis, str(tmp_path / "j.jpg"), nrow=2)
        _grey_close(tmp_path / "t.jpg", tmp_path / "j.jpg")
    elif sheet == "heatmaps":
        tvis.save_batch_heatmaps(imgs, hms, str(tmp_path / "t.jpg"))
        jvis.save_batch_heatmaps(imgs, hms, str(tmp_path / "j.jpg"))
        _grey_close(tmp_path / "t.jpg", tmp_path / "j.jpg")
    else:
        jcfg, tcfg = jax_config(), default_config()
        norm = rng.randn(5, 32, 32, 3).astype(np.float32)
        tvis.save_debug_images(tcfg, torch.from_numpy(norm), torch.from_numpy(joints),
                               torch.from_numpy(vis), joints, torch.from_numpy(hms), hms,
                               str(tmp_path / "t" / "x"))
        jvis.save_debug_images(jcfg, norm, joints, vis, joints, hms, hms, str(tmp_path / "j" / "x"))
        names = sorted(os.listdir(tmp_path / "j"))
        assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 4
        for n in names:
            _grey_close(tmp_path / "t" / n, tmp_path / "j" / n)
        tcfg.DEBUG.DEBUG = False
        tvis.save_debug_images(tcfg, norm, joints, vis, joints, hms, hms, str(tmp_path / "u" / "x"))
        assert not (tmp_path / "u").exists()


def _assert_same_outputs(tdir, jdir):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for n in names:
        if n.endswith(".jsonl"):
            assert (tdir / n).read_bytes() == (jdir / n).read_bytes()
    sheets = sorted(os.listdir(jdir / "debug"))
    assert sorted(os.listdir(tdir / "debug")) == sheets and sheets
    for n in sheets:
        _grey_close(tdir / "debug" / n, jdir / "debug" / n)


def test_mpii_evaluate_matches_jax_and_draws_its_sheets(roots, monkeypatch, tmp_path):
    jds, tds = datasets("mpii", roots["zip"], monkeypatch, subset="valid", is_train=False)
    flat = [i for g in tds.grouping for i in g]
    gt = np.array([tds.db[i]["joints_2d"] for i in flat])
    rs = np.random.RandomState(0)
    pred = gt + rs.randn(*gt.shape) * np.linspace(0.5, 8, len(flat))[:, None, None]
    ref_nv, ref = jds.evaluate(pred, str(tmp_path / "j"))
    got_nv, got = tds.evaluate(pred, str(tmp_path / "t"))
    assert got == ref and 0 < got < 1
    assert list(got_nv) == list(ref_nv)
    np.testing.assert_array_equal(list(got_nv.values()), list(ref_nv.values()))
    _assert_same_outputs(tmp_path / "t", tmp_path / "j")


def test_h36m_evaluate_output_dir_writes_jax_files(roots, monkeypatch, tmp_path):
    jds, tds = datasets("multiview_h36m", roots["zip"], monkeypatch, subset="validation",
                        is_train=False)
    j, _ = tds.gt_joints_flat(union=False)
    pred = j + np.random.RandomState(1).randn(*j.shape) * 3.0
    ref_nv, ref = jds.evaluate(pred, str(tmp_path / "j"))
    got_nv, got = tds.evaluate(pred, str(tmp_path / "t"))
    assert got == ref and list(got_nv) == list(ref_nv)
    _assert_same_outputs(tmp_path / "t", tmp_path / "j")


def test_coco_and_mixed_evaluate_raise_as_jax(roots, monkeypatch):
    for name in ("coco", "mixed"):
        _, tds = datasets(name, roots["zip"], monkeypatch)
        with pytest.raises(NotImplementedError):
            tds.evaluate(np.zeros((4, 16, 2)))


def test_synthetic_fixture_layout(tmp_path):
    """write_image_fixture's counts and files, its joints on its blobs."""
    root = tmp_path / "fx"
    n = write_image_fixture(str(root), n_images=4, mpii_size=(80, 60), h36m_size=(100, 100),
                            mpii_train=8, mpii_valid=4, h36m_train_groups=2,
                            h36m_valid_groups=2)
    assert n["images"] == 8
    cfg = default_config()
    cfg.DATASET.ROOT, cfg.DATASET.DATA_FORMAT = str(root), "zip"
    train = tregistry.get_dataset("mixed")(cfg, "train", True)
    valid = tregistry.get_dataset("multiview_h36m")(cfg, "validation", False)
    assert (len(train.h36m), len(train.mpii), len(valid)) == (2, 2, 2)
    with zipfile.ZipFile(root / "mpii" / "images.zip") as zf:
        assert len(zf.namelist()) == 4
    rec = train.mpii.db[0]
    img = tzip.imread(train._image_path(rec))
    x, y = np.round(rec["joints_2d"][6]).astype(int)  # the root's white disc
    assert img[y, x].min() > 200
    shutil.rmtree(root)
