"""mpit_tpu_torch's data slice for the classifiers (the augmentation, the
augmented synthetic stream, the npy datasets and their writers, the
image importer, the ``--data-dir`` and ``--augment`` flags) against
mpit_tpu's, on the CPU.

Every comparison is bit for bit: the port's numpy copies make the same
``RandomState`` draws in the same order on the same arrays. The npy
directories and the PNG tree are written by the tests, under pytest's
``tmp_path``.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from mpit_tpu.data import augment as jaug
from mpit_tpu.data import filedata as jfile
from mpit_tpu.data import images as jimages
from mpit_tpu.data import synthetic as jsynth
from mpit_tpu_torch.asyncsgd import runner
from mpit_tpu_torch.asyncsgd.__main__ import main as cli_main
from mpit_tpu_torch.data import augment as taug
from mpit_tpu_torch.data import filedata as tfile
from mpit_tpu_torch.data import images as timages
from mpit_tpu_torch.data import synthetic as tsynth
from mpit_tpu_torch.models import ResNet50

tresnet = importlib.import_module("mpit_tpu_torch.asyncsgd.resnet")

CPU = ["--device", "cpu"]


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _images(b=6, h=20, w=24, c=3, seed=0):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


# ---- the transforms ----------------------------------------------------------


@pytest.mark.parametrize("pad, hflip", [(4, True), (0, True), (2, False)])
def test_augment_images_bit_equal(pad, hflip):
    x = _images()
    got = taug.augment_images(x, np.random.RandomState(3), pad=pad, hflip=hflip)
    want = jaug.augment_images(x, np.random.RandomState(3), pad=pad, hflip=hflip)
    np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(got, x)


@pytest.mark.parametrize(
    "kw",
    [{}, {"out_hw": (16, 16)}, {"out_hw": (32, 28), "scale": (0.5, 1.0)},
     # No draw fits: the centre-crop fallback, on both sides of the ratio.
     {"scale": (5.0, 6.0), "ratio": (3.0, 4.0)}, {"scale": (5.0, 6.0), "ratio": (0.2, 0.3)}],
    ids=["stored_size", "down", "up", "fallback_wide", "fallback_tall"],
)
def test_random_resized_crop_bit_equal(kw):
    x = _images()
    got = taug.random_resized_crop(x, np.random.RandomState(4), **kw)
    want = jaug.random_resized_crop(x, np.random.RandomState(4), **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(16, 16), (20, 24), (30, 26)], ids=["crop", "same", "resize"])
def test_center_crop_bit_equal(hw):
    x = _images()
    np.testing.assert_array_equal(taug.center_crop(x, *hw), jaug.center_crop(x, *hw))


# ---- the augmented synthetic stream -----------------------------------------------


def test_augmented_synthetic_stream_bit_equal():
    kw = dict(image_shape=(16, 16, 3), num_classes=5, seed=2, augment=True, crop_pad=3)
    t, j = tsynth.SyntheticClassification(**kw), jsynth.SyntheticClassification(**kw)
    ts, js = t.batches(4), j.batches(4)
    for _ in range(2):
        _same(next(ts), next(js))
    _same(next(t.batches(4, skip=3)), next(j.batches(4, skip=3)))
    plain = tsynth.SyntheticClassification(**{**kw, "augment": False})
    assert not np.array_equal(next(t.batches(4))["image"], next(plain.batches(4))["image"])
    # Eval and val batches are never augmented.
    _same(t.eval_batch(4), plain.eval_batch(4))
    _same(next(t.val_batches(4)), next(plain.val_batches(4)))


# ---- the npy datasets ----------------------------------------------------------------


def _write(root, mod, *, val=True, n=20, hw=(12, 14), dtype=np.uint8):
    rng = np.random.RandomState(0)
    imgs = (rng.rand(n, *hw, 3) * 255).astype(dtype)
    labels = rng.randint(0, 4, n)
    mod.write_classification(str(root), imgs, labels)
    if val:
        mod.write_classification(str(root), imgs[:7], labels[:7], split="val")
    return str(root)


_FILE_CASES = {
    "plain": {},
    "shift": {"augment": True, "crop_pad": 2},
    "rrc": {"augment": True, "augment_mode": "rrc", "train_size": 10, "rrc_scale": (0.3, 1.0)},
    "train_size": {"train_size": 8},
}


@pytest.mark.parametrize("case", sorted(_FILE_CASES))
def test_file_classification_bit_equal(tmp_path, case):
    d = _write(tmp_path, jfile)
    kw = {"seed": 3, **_FILE_CASES[case]}
    t, j = tfile.FileClassification(d, **kw), jfile.FileClassification(d, **kw)
    assert (t.num_classes, t.image_shape, len(t), t.val_size) == (
        j.num_classes, j.image_shape, len(j), j.val_size)
    ts, js = t.batches(8), j.batches(8)
    for _ in range(5):  # across an epoch's end (20 rows, 2 batches an epoch)
        _same(next(ts), next(js))
    _same(next(t.batches(8, skip=3)), next(j.batches(8, skip=3)))
    tv, jv = list(t.val_batches(3)), list(j.val_batches(3))
    assert len(tv) == len(jv) == 3  # 7 rows: the last batch one row and two pads
    for a, b in zip(tv, jv):
        _same(a, b)
    assert tv[-1]["valid"].tolist() == [1.0, 0.0, 0.0]
    _same(t.eval_batch(5), j.eval_batch(5))


def test_file_datasets_refuse_what_they_cannot_serve(tmp_path):
    d = _write(tmp_path / "c", tfile, val=False)
    assert isinstance(tfile.load_dataset(d), tfile.FileClassification)
    assert tfile.FileClassification(d).val_size == 20  # no val split: the train split
    with pytest.raises(ValueError, match="augment_mode"):
        tfile.FileClassification(d, augment_mode="crop")
    with pytest.raises(ValueError, match="exceeds"):
        next(tfile.FileClassification(d).batches(21))
    lm = tmp_path / "lm"
    jfile.write_lm(str(lm), np.arange(100))
    with pytest.raises(NotImplementedError, match="data-pipeline slice"):
        tfile.load_dataset(str(lm))
    with pytest.raises(ValueError, match="expected 'classification'"):
        tfile.FileClassification(str(lm))


def test_writers_write_what_jax_writes(tmp_path):
    imgs = (np.random.RandomState(1).rand(6, 5, 5, 3) * 255).astype(np.uint8)
    labels = np.array([0, 1, 2, 0, 1, 2])
    for mod, root in ((tfile, tmp_path / "t"), (jfile, tmp_path / "j")):
        arr = mod.open_classification_images(str(root), "train", 6, (5, 5))
        arr[:] = imgs
        arr.flush()
        del arr
        mod.finalize_classification(str(root), labels)
        # A val split whose labels miss the top class keeps num_classes 3.
        mod.write_classification(str(root), imgs[:2], labels[:2], split="val")
    for name in ("meta.json", "train_images.npy", "train_labels.npy", "val_labels.npy"):
        with open(tmp_path / "t" / name, "rb") as a, open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert json.load(open(tmp_path / "t" / "meta.json"))["num_classes"] == 3
    with pytest.raises(FileNotFoundError, match="partial"):
        tfile.finalize_classification(str(tmp_path / "t"), labels)


def test_import_image_directory_matches_jax(tmp_path):
    from PIL import Image

    src = tmp_path / "src"
    rng = np.random.RandomState(0)
    for cls, n in (("cat", 3), ("dog", 2)):
        (src / cls).mkdir(parents=True)
        for i in range(n):
            h, w = (20, 30) if i % 2 else (28, 18)
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                src / cls / f"{i}.png")
    one = timages.decode_image(str(src / "cat" / "1.png"), 16)
    assert one.shape == (16, 16, 3) and one.dtype == np.uint8
    np.testing.assert_array_equal(one, jimages.decode_image(str(src / "cat" / "1.png"), 16))
    for mod, out in ((timages, tmp_path / "t"), (jimages, tmp_path / "j")):
        mod.import_image_directory(str(src), str(out), size=16, val_fraction=0.3, seed=1)
    for name in ("train_images.npy", "train_labels.npy", "val_images.npy", "val_labels.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name), err_msg=name)
    meta = json.load(open(tmp_path / "t" / "meta.json"))
    assert meta == json.load(open(tmp_path / "j" / "meta.json"))
    assert meta["class_names"] == ["cat", "dog"] and meta["num_classes"] == 2
    assert not any(f.endswith(".partial") for f in os.listdir(tmp_path / "t"))


# ---- the flags ----------------------------------------------------------------------------


def test_data_dir_and_augment_select_the_dataset(tmp_path):
    from mpit_tpu_torch.asyncsgd.config import TrainConfig

    d = _write(tmp_path, tfile)
    cfg = TrainConfig(data_dir=d, augment=True, augment_mode="rrc", train_size=10,
                      rrc_min_scale=0.2, seed=4)
    ds = runner.classification_dataset(cfg, lambda: pytest.fail("the synthetic stream"))
    assert isinstance(ds, tfile.FileClassification)
    assert (ds.augment_mode, ds.train_size, ds.rrc_scale, ds.seed) == ("rrc", 10, (0.2, 1.0), 4)
    syn = runner.classification_dataset(
        TrainConfig(augment=True, crop_pad=2),
        lambda: tsynth.SyntheticClassification(image_shape=(8, 8, 1)))
    assert syn.augment and syn.crop_pad == 2
    with pytest.raises(SystemExit, match=r"LeNet expects \(28, 28, 1\)"):
        cli_main(["mnist", "--data-dir", d, *CPU])  # 12×14×3 images


def test_resnet_trains_from_an_npy_directory(tmp_path, capsys, monkeypatch):
    """``--data-dir`` with rrc to ``--train-size``: the model's classes
    and image size come from the directory (4 classes, 10×10 crops). The
    model is cut to two stages, as in ``test_torch_resnet.py``'s CLI
    tests: its full depth costs minutes on a loaded CPU."""
    monkeypatch.setattr(tresnet, "ResNet50",
                        lambda *a, **kw: ResNet50(*a, stage_sizes=(1, 1), **kw))
    d = _write(tmp_path, tfile, hw=(12, 12))
    assert cli_main(["resnet", "--data-dir", d, "--augment", "true", "--augment-mode", "rrc",
                     "--train-size", "10", "--steps", "2", "--batch-size", "4",
                     "--eval-batch", "4", "--eval-every", "2", "--eval-batches", "1",
                     "--lr", "0.01", *CPU]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    assert set(out["eval"]) == {"loss", "top1"}  # 4 classes: no top-5


@pytest.mark.parametrize(
    "argv, match",
    [(["mnist", "--native", "true"], "data-pipeline slice"),
     (["imagenet", "--augment", "true", "--augment-mode", "rrc"], "need --data-dir"),
     (["mnist", "--train-size", "20"], "need --data-dir"),
     (["gpt2", "--data-dir", "/d"], "FileLM"),
     (["gpt2", "--crop-pad", "2"], "image augmentation")],
    ids=["native", "rrc_without_data_dir", "train_size_without_data_dir", "gpt2_data_dir",
         "gpt2_crop_pad"],
)
def test_data_flag_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_main([*argv, *CPU])
