"""The port's host data layer against the JAX package's: medical-image IO,
cross-validation splits (sklearn's train_test_split in the JAX package, the
port's own), slice datasets, the batch loader, the native helpers and the
prefetch thread.

Everything here is numpy on the host, so the bar is equality: volumes,
slices, batches and split lists bit for bit, files byte for byte where the
format holds no timestamp (raw NRRD, NIfTI; gzip headers carry the time of
writing, so gzip files are compared by content). Volumes are small: 3
slices, 40^2 pads and 32^2 crops.
"""

import os
import threading

import numpy as np
import pytest

from maxstyle_tpu import native as jnative
from maxstyle_tpu.data import datasets as jds
from maxstyle_tpu.data import medio as jmedio
from maxstyle_tpu.data import prefetch as jprefetch
from maxstyle_tpu.data import splits as jsplits
from maxstyle_tpu_torch import native as tnative
from maxstyle_tpu_torch.data import datasets as tds
from maxstyle_tpu_torch.data import medio as tmedio
from maxstyle_tpu_torch.data import prefetch as tprefetch
from maxstyle_tpu_torch.data import splits as tsplits

PAD, CROP = (40, 40), (32, 32)
ACDC_SPACING = (1.5625, 1.5625, 10.0)
NEW_SPACING = (1.36719, 1.36719, -1)


def _volume(rng, shape, classes=4):
    s, h, w = shape
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot(yy - h / 2 + rng.uniform(-3, 3), xx - w / 2 + rng.uniform(-3, 3))
    lab = np.zeros(shape, np.uint8)
    for k, rad in zip(range(classes - 1, 0, -1), (9.0, 6.0, 3.0)):
        lab[:, r < rad] = k
    lab[0] = 0  # one black slice a volume: left out of the slice index
    img = (rng.rand(*shape) * 100 + lab * 50).astype(np.float32)
    return img, lab


def write_acdc_tree(root, cval=0, shape=(3, 36, 30), seed=0):
    """{root}/{ES,ED}/{pid}_img.nrrd and _seg.nrrd for the patients of
    acdc_split("10", cval), at ACDC's usual spacing."""
    rng = np.random.RandomState(seed)
    split = tsplits.acdc_split("10", cval)
    for pid in sorted(set(split["train"] + split["validate"])):
        for frame in ("ES", "ED"):
            os.makedirs(os.path.join(root, frame), exist_ok=True)
            img, lab = _volume(rng, shape)
            tmedio.write_nrrd(os.path.join(root, frame, f"{pid}_img.nrrd"), img, ACDC_SPACING)
            tmedio.write_nrrd(os.path.join(root, frame, f"{pid}_seg.nrrd"), lab, ACDC_SPACING)
    return root


def write_prostate_site(root, n=8, shape=(3, 40, 40), seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        d = os.path.join(root, f"patient_{i}")
        os.makedirs(d, exist_ok=True)
        img, lab = _volume(rng, shape, classes=2)
        tmedio.write_nifti(os.path.join(d, "t2_img_clipped.nii.gz"), img, (0.6, 0.6, 3.6))
        tmedio.write_nifti(os.path.join(d, "label_clipped.nii.gz"), lab.astype(np.int16),
                           (0.6, 0.6, 3.6))
    return root


# ---------------------------------------------------------------------------
# medio
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16, np.int32, np.float64])
@pytest.mark.parametrize("ext", ["nrrd", "raw.nrrd", "nii", "nii.gz"])
def test_medio_reads_and_writes_are_bit_equal_both_ways(tmp_path, dtype, ext):
    rng = np.random.RandomState(1)
    vol = (rng.rand(3, 7, 5) * 50).astype(dtype)
    spacing = (0.7, 1.25, 3.5)
    compress = {"compress": False} if ext == "raw.nrrd" else {}
    write = {"nrrd": "write_nrrd", "raw.nrrd": "write_nrrd"}.get(ext, "write_nifti")
    paths = {}
    for name, mod in (("j", jmedio), ("t", tmedio)):
        paths[name] = str(tmp_path / f"{name}.{ext}")
        getattr(mod, write)(paths[name], vol, spacing, **compress)
    for reader in (jmedio, tmedio):
        for src in paths.values():
            got, sp = reader.read_volume(src)
            want, want_sp = jmedio.read_volume(paths["j"])
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert sp == want_sp
    if not ext.endswith(".gz") and ext != "nrrd":
        assert open(paths["j"], "rb").read() == open(paths["t"], "rb").read()


def test_resample_and_crop_or_pad_match():
    rng = np.random.RandomState(2)
    img, lab = _volume(rng, (3, 36, 30))
    for args in ((img, ACDC_SPACING, NEW_SPACING), (img, ACDC_SPACING, (1.0, 2.0, 5.0))):
        a, sa = jmedio.resample_by_spacing(*args)
        b, sb = tmedio.resample_by_spacing(*args)
        assert sa == sb and np.array_equal(a, b)
    a, _ = jmedio.resample_by_spacing(lab, ACDC_SPACING, NEW_SPACING, label=True)
    b, _ = tmedio.resample_by_spacing(lab, ACDC_SPACING, NEW_SPACING, label=True)
    assert np.array_equal(a, b)
    for hw in ((40, 40), (20, 33), (36, 30)):
        assert np.array_equal(jmedio.crop_or_pad(img, hw), tmedio.crop_or_pad(img, hw))


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

ACDC_IDENTIFIERS = ["standard", "one_shot", "three_shot", "25_shot", "one_shot_upperbound",
                    "three_shot_upperbound", "25_shot_upperbound", "1", "3", "5", "10", "20",
                    "39", "40", "0.1", "0.25", "0.5"]


@pytest.mark.parametrize("identifier", ACDC_IDENTIFIERS)
def test_acdc_split_equals_the_jax_package(identifier):
    for cval in range(5):
        assert tsplits.acdc_split(identifier, cval) == jsplits.acdc_split(identifier, cval)


@pytest.mark.parametrize("identifier", ["all", "full", "three_shot", "three_shot_upperbound",
                                        "0.4", "5"])
def test_prostate_split_equals_the_jax_package(identifier):
    for n in (12, 32, 47):
        ids = [f"patient_{i}" for i in range(n)]
        for cval in range(5):
            assert (tsplits.prostate_split(ids, identifier, cval)
                    == jsplits.prostate_split(ids, identifier, cval))


@pytest.mark.parametrize("identifier", ["one_shot", "three_shot", "five_shot", "15_shot", "full"])
def test_ukbb_split_equals_the_jax_package(identifier):
    for cval in range(5):
        assert tsplits.ukbb_split(identifier, cval) == jsplits.ukbb_split(identifier, cval)


def test_train_test_split_equals_sklearn_and_raises_where_it_raises():
    from sklearn.model_selection import train_test_split as sk
    sizes = [dict(test_size=0.1), dict(test_size=0.3), dict(test_size=2), dict(train_size=3),
             dict(train_size=0.4), dict(train_size=0.9), dict(train_size=25), {},
             dict(train_size=0.5, test_size=0.2), dict(train_size=2, test_size=2)]
    for n in range(1, 40):
        x = [f"p{i}" for i in range(n)]
        for cv in range(5):
            for kw in sizes:
                try:
                    want = [list(part) for part in sk(x, random_state=cv, **kw)]
                except ValueError:
                    with pytest.raises(ValueError):
                        tsplits.train_test_split(x, random_state=cv, **kw)
                    continue
                assert list(tsplits.train_test_split(x, random_state=cv, **kw)) == want


# ---------------------------------------------------------------------------
# datasets and the loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def acdc_root(tmp_path_factory):
    return write_acdc_tree(str(tmp_path_factory.mktemp("acdc")))


@pytest.fixture(scope="module")
def prostate_root(tmp_path_factory):
    return write_prostate_site(str(tmp_path_factory.mktemp("prostate")))


def _datasets(kind, root, split):
    if kind == "acdc":
        kw = dict(frames=("ES", "ED"), pad_hw=PAD, crop_hw=CROP, new_spacing=NEW_SPACING)
        return (jds.build_acdc_dataset(root, split, "10", 0, **kw),
                tds.build_acdc_dataset(root, split, "10", 0, **kw))
    kw = dict(pad_hw=PAD, crop_hw=CROP)
    return (jds.build_prostate_dataset(root, split, "all", 0, **kw),
            tds.build_prostate_dataset(root, split, "all", 0, **kw))


def _assert_same_dataset(j, t):
    assert len(j) == len(t) > 0
    assert j.patient_ids == t.patient_ids
    for i in range(len(j)):
        (ji, jl, jp), (ti, tl, tp) = j.get_raw_slice(i), t.get_raw_slice(i)
        assert jp == tp
        assert ji.dtype == ti.dtype and np.array_equal(ji, ti)
        assert jl.dtype == tl.dtype and np.array_equal(jl, tl)
    parts = getattr(j, "datasets", [j])
    for jd, td in zip(parts, getattr(t, "datasets", [t])):
        assert jd.slice_index == td.slice_index
        for pid in jd.patient_ids:
            (jv, jlab, jsp), (tv, tlab, tsp) = (jd.get_patient_volume(pid),
                                                td.get_patient_volume(pid))
            assert jsp == tsp
            assert jv.dtype == tv.dtype and np.array_equal(jv, tv)
            assert jlab.dtype == tlab.dtype and np.array_equal(jlab, tlab)


@pytest.mark.parametrize("split", ["train", "validate"])
def test_acdc_datasets_are_bit_equal(acdc_root, split):
    _assert_same_dataset(*_datasets("acdc", acdc_root, split))


@pytest.mark.parametrize("split", ["train", "validate"])
def test_prostate_datasets_are_bit_equal(prostate_root, split):
    _assert_same_dataset(*_datasets("prostate", prostate_root, split))


def test_general_dataset_and_disk_cache_are_bit_equal(acdc_root, tmp_path):
    root = os.path.join(acdc_root, "ED")
    kw = dict(pad_hw=PAD, crop_hw=CROP, new_spacing=NEW_SPACING)
    j = jds.build_general_dataset(root, "{pid}_img.nrrd", "{pid}_seg.nrrd", **kw)
    t = tds.build_general_dataset(root, "{pid}_img.nrrd", "{pid}_seg.nrrd", **kw)
    # flat files under the root: the general layout finds none of them
    assert j.patient_ids == t.patient_ids == []
    pids = sorted(f[:-9] for f in os.listdir(root) if f.endswith("_img.nrrd"))
    j = jds.SliceDataset(root, pids, "{pid}_img.nrrd", "{pid}_seg.nrrd",
                         disk_cache_dir=str(tmp_path / "j"), dataset_name="ED", **kw)
    t = tds.SliceDataset(root, pids, "{pid}_img.nrrd", "{pid}_seg.nrrd",
                         disk_cache_dir=str(tmp_path / "t"), dataset_name="ED", **kw)
    _assert_same_dataset(j, t)
    # a second scan reads the disk cache
    t2 = tds.SliceDataset(root, pids, "{pid}_img.nrrd", "{pid}_seg.nrrd",
                          disk_cache_dir=str(tmp_path / "t"), dataset_name="ED", **kw)
    _assert_same_dataset(j, t2)


@pytest.mark.parametrize("shuffle,drop_last,seed", [(True, True, 3), (False, False, 3),
                                                    (True, False, None)])
def test_host_batch_loader_batches_are_bit_equal(acdc_root, shuffle, drop_last, seed):
    j, t = _datasets("acdc", acdc_root, "train")
    jl = jds.HostBatchLoader(j, 4, seed=seed, drop_last=drop_last, shuffle=shuffle)
    tl = tds.HostBatchLoader(t, 4, seed=seed, drop_last=drop_last, shuffle=shuffle)
    assert len(jl) == len(tl)
    for _ in range(2):  # two epochs: the shuffle order carries on
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            for k in ("image", "label"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# native helpers
# ---------------------------------------------------------------------------


def test_native_helpers_equal_their_numpy_versions_and_the_jax_package():
    rng = np.random.RandomState(4)
    vol = (rng.randn(3, 37, 29) * 10).astype(np.float32)
    lab = rng.randint(0, 4, (3, 37, 29)).astype(np.int32)
    for hw in ((40, 40), (32, 32), (20, 45), (37, 29)):
        for v in (vol, lab):
            got = tnative.crop_or_pad(v, hw)
            assert got.dtype == v.dtype
            assert np.array_equal(got, tnative.crop_or_pad_plain(v, hw))
            assert np.array_equal(got, jnative.crop_or_pad(v, hw))
    flat = vol.copy()
    flat[1] = 2.5  # a constant slice: max - min = 0
    for v in (vol, flat, vol[:, ::2]):
        want = tnative.minmax_norm_slices_plain(v)
        assert np.array_equal(tnative.minmax_norm_slices(v.copy()), want)
        assert np.array_equal(jnative.minmax_norm_slices(np.ascontiguousarray(v)), want)
    vols = [vol, vol[::-1].copy(), vol * 2]
    vi, si = np.array([2, 0, 1, 0]), np.array([1, 2, 0, 0])
    for vs in (vols, [v.view(np.int32) for v in vols]):
        got = tnative.gather_pack(vs, vi, si)
        assert np.array_equal(got, tnative.gather_pack_plain(vs, vi, si))
        assert np.array_equal(got, jnative.gather_pack(vs, vi, si))
    with pytest.raises(TypeError):
        tnative.crop_or_pad(vol.astype(np.float64), (8, 8))
    with pytest.raises(IndexError):
        tnative.gather_pack(vols, [3], [0])
    with pytest.raises(IndexError):
        tnative.gather_pack(vols, [0], [3])


def test_native_library_is_built_under_the_checkout():
    tnative.get_lib()
    assert tnative._lib_path().exists()
    assert tnative.BUILD_DIR.parent.parent == tnative.SOURCE.parent.parent.parent


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def test_prefetch_keeps_order_applies_the_transform_and_propagates_errors():
    items = list(range(50))
    assert list(tprefetch.prefetch(items, depth=3)) == list(jprefetch.prefetch(items, depth=3))
    assert list(tprefetch.prefetch(items, depth=1, transform=lambda x: 2 * x)) == \
        [2 * x for x in items]

    def broken():
        yield 1
        yield 2
        raise KeyError("loader failed")

    got = []
    with pytest.raises(KeyError, match="loader failed"):
        for x in tprefetch.prefetch(broken()):
            got.append(x)
    assert got == [1, 2]


def test_prefetch_releases_its_thread_when_the_consumer_stops_early():
    before = threading.active_count()
    it = iter(tprefetch.prefetch(range(10_000), depth=2))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before
