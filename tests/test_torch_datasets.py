"""fsnerf_tpu_torch's data layer against fsnerf_tpu's: the K-means view
selection, the LLFF pose helpers, the image decoder and the PNG writer,
the Blender and LLFF loaders and the Splitter, each fed the same numpy
inputs or the same on-disk scene written with PIL.
"""

import json
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from fsnerf_tpu.data import blender as jblender
from fsnerf_tpu.data import kmeans as jkmeans
from fsnerf_tpu.data import llff as jllff
from fsnerf_tpu.data import poses as jposes
from fsnerf_tpu.data import splitter as jsplitter
from fsnerf_tpu_torch import native
from fsnerf_tpu_torch.data import blender, kmeans, llff, poses, splitter

# ---------------- fixtures ----------------


def _rotation(rng, scale):
    """A random rotation near the identity (Rodrigues of a small axis)."""
    w = scale * rng.normal(size=3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    """A Blender-format scene: 12 RGBA views on the upper hemisphere and 2
    below it (dropped by the few-shot filter), alpha on half the pixels."""
    root = tmp_path_factory.mktemp("datasets")
    scene_dir = root / "synthetic" / "minilego"
    os.makedirs(scene_dir / "train")
    H = W = 10
    frames = []
    rng = np.random.default_rng(0)
    for i in range(14):
        theta = 30.0 + 4 * i if i < 12 else 120.0 + 10 * i
        pose = jposes.pose_from_spherical(4.0, theta, 33.0 * i)
        name = f"train/r_{i}"
        img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
        img[..., 3] = 255 * (rng.uniform(size=(H, W)) > 0.5)
        Image.fromarray(img, "RGBA").save(scene_dir / f"{name}.png")
        frames.append({"file_path": name,
                       "transform_matrix": pose.tolist()})
    with open(scene_dir / "transforms_train.json", "w") as fh:
        json.dump({"camera_angle_x": 0.6911112, "frames": frames}, fh)
    return str(root)


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    """An LLFF-format scene: 14 forward-facing views with small rotations,
    poses_bounds.npy in the LLFF column convention, images_8/ PNGs."""
    root = tmp_path_factory.mktemp("datasets")
    scene_dir = root / "llff" / "miniroom"
    os.makedirs(scene_dir / "images_8")
    H, W, focal = 8, 12, 400.0
    rng = np.random.default_rng(1)
    rows = []
    for i in range(14):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        Image.fromarray(img).save(scene_dir / "images_8" / f"im_{i:03d}.png")
        rot = _rotation(rng, 0.05)
        c2w = np.zeros((3, 5), np.float32)
        # LLFF [x_down, y_right, back] columns of the NeRF [right, up, back]
        c2w[:3, 0] = -rot[:, 1]
        c2w[:3, 1] = rot[:, 0]
        c2w[:3, 2] = rot[:, 2]
        c2w[:3, 3] = 0.1 * rng.normal(size=3)
        c2w[:, 4] = [H * 8, W * 8, focal * 8]
        rows.append(np.concatenate([c2w.flatten(), [2.0 + 0.1 * i, 8.0]]))
    np.save(scene_dir / "poses_bounds.npy", np.stack(rows))
    return str(root)


def five_filter_image(rng, H, W, c):
    """uint8 [H, W, c] whose rows suit the five PNG row filters in turn:
    zeros (none), a ramp along x (sub), the row above (up), the mean of
    left and up (average), a perturbed copy of the row above (Paeth) and
    noise."""
    img = np.zeros((H, W, c), np.int64)
    for r in range(H):
        kind = r % 6
        if kind == 1:
            img[r] = (rng.integers(0, 256, c) + 3 * np.arange(W)[:, None]) \
                % 256
        elif kind == 2:
            img[r] = img[r - 1]
        elif kind == 3:
            img[r, 0] = rng.integers(0, 256, c)
            for x in range(1, W):
                img[r, x] = (img[r, x - 1] + img[r - 1, x]) // 2
        elif kind == 4:
            img[r] = np.clip(img[r - 1] + rng.integers(-40, 40, c), 0, 255)
        elif kind == 5:
            img[r] = rng.integers(0, 256, (W, c))
    return img.astype(np.uint8)


def png_filters(path) -> set:
    """The row filter types a PNG file uses."""
    with open(path, "rb") as fh:
        raw = fh.read()
    pos, idat = 8, b""
    while pos < len(raw):
        n = int.from_bytes(raw[pos:pos + 4], "big")
        if raw[pos + 4:pos + 8] == b"IDAT":
            idat += raw[pos + 8:pos + 8 + n]
        pos += 12 + n
    img = Image.open(path)
    rowbytes = img.width * len(img.getbands()) + 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(-1,
                                                                  rowbytes)
    return set(rows[:, 0].tolist())


# ---------------- K-means and poses ----------------


@pytest.mark.parametrize("n,k,seed", [(40, 8, 42), (24, 3, 0), (7, 7, 1)])
def test_kmeans_and_selection_match_jax(n, k, seed):
    x = np.random.default_rng(seed).normal(size=(n, 3))
    for a, b in zip(kmeans.kmeans(x, k, seed=seed),
                    jkmeans.kmeans(x, k, seed=seed)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        kmeans.select_representative_views(x, k, seed),
        jkmeans.select_representative_views(x, k, seed))


def test_recenter_and_spiral_match_jax():
    rng = np.random.default_rng(3)
    ps = np.stack([np.concatenate([_rotation(rng, 0.1),
                                   rng.normal(size=(3, 1))], 1)
                   for _ in range(9)]).astype(np.float32)
    bounds = rng.uniform(1.5, 9.0, (9, 2)).astype(np.float32)
    np.testing.assert_allclose(poses.recenter_poses(ps),
                               jposes.recenter_poses(ps), atol=1e-6)
    for zflat in (False, True):
        np.testing.assert_allclose(
            poses.spiral_path(ps, bounds, path_zflat=zflat),
            jposes.spiral_path(ps, bounds, path_zflat=zflat), atol=1e-6)
    np.testing.assert_allclose(poses.avg_pose(ps), jposes.avg_pose(ps),
                               atol=1e-6)


# ---------------- decoder and PNG writer ----------------


@pytest.mark.parametrize("channels", [3, 4])
def test_decoder_matches_jax_loader_on_every_filter(tmp_path, channels):
    """PIL-written PNGs whose rows use all five filter types decode to the
    JAX loader's float32 pixels bitwise."""
    rng = np.random.default_rng(channels)
    paths = []
    for i in range(3):
        img = five_filter_image(rng, 30, 17 + i, channels)
        path = str(tmp_path / f"im_{i}.png")
        Image.fromarray(img).save(path, optimize=True)
        paths.append(path)
    assert set().union(*map(png_filters, paths)) == {0, 1, 2, 3, 4}
    for p in paths:
        got = native.decode_images([p])
        np.testing.assert_array_equal(got, jblender.load_images([p]))
        assert got.dtype == np.float32 and got.shape[-1] == channels
    assert native.probe_image(paths[0]) == (30, 17, channels)


def test_decoder_converts_formats_as_the_jax_loader(tmp_path):
    """Gray, gray + alpha, palette (with and without tRNS), 1-bit, 16-bit
    and an RGB colour key, and a batch mixing RGB and RGBA."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    rgb = Image.fromarray(base[..., :3])
    images = {
        "gray": (Image.fromarray(base[..., 0]), {}),
        "gray_alpha": (Image.fromarray(base[..., :2], "LA"), {}),
        "palette": (rgb.convert("P"), {}),
        "palette_trns": (rgb.convert("P"), {"transparency": 5}),
        "bits1": (Image.fromarray(base[..., 0] > 128), {}),
        "bits16": (Image.fromarray(base[..., 0].astype(np.uint16) * 257 + 3),
                   {}),
        "rgb_key": (rgb, {"transparency": tuple(int(v)
                                                for v in base[0, 0, :3])}),
    }
    for name, (img, kw) in images.items():
        path = str(tmp_path / f"{name}.png")
        img.save(path, **kw)
        np.testing.assert_array_equal(native.decode_images([path]),
                                      jblender.load_images([path]),
                                      err_msg=name)
    mixed = [str(tmp_path / "rgb_key.png"), str(tmp_path / "gray.png")]
    from fsnerf_tpu.native import decode_images as jdecode
    for c in (3, 4):
        np.testing.assert_array_equal(native.decode_images(mixed, channels=c),
                                      jdecode(mixed, channels=c))


def test_decoder_refuses_what_it_cannot_read(tmp_path):
    """Images of different sizes in one call raise; a JPEG and an
    Adam7-interlaced PNG decode as the JAX decoder decodes them
    (tests/test_torch_jpeg.py covers both formats in full)."""
    from fsnerf_tpu.native import decode_images as jdecode

    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(a)
    Image.fromarray(np.zeros((5, 4, 3), np.uint8)).save(b)
    with pytest.raises(IOError, match="mismatch"):
        native.decode_images([a, b])
    rgb = np.random.default_rng(4).integers(0, 256, (4, 5, 3), np.uint8)
    jpg = str(tmp_path / "c.jpg")
    Image.fromarray(rgb).save(jpg)
    np.testing.assert_array_equal(native.decode_images([jpg]),
                                  jdecode([jpg]))
    # an Adam7-interlaced PNG: a written PNG's IHDR marked interlaced, its
    # image data the seven passes' rows (filter 0)
    raw = native.encode_png(rgb)
    ihdr = bytearray(raw[16:29])
    ihdr[12] = 1
    passes = [rgb[y0::dy, x0::dx] for x0, y0, dx, dy in native.ADAM7]
    rows = b"".join(b"\x00" + r.tobytes() for p in passes if p.size
                    for r in p)
    interlaced = tmp_path / "d.png"
    interlaced.write_bytes(
        raw[:8] + native._chunk(b"IHDR", bytes(ihdr))
        + native._chunk(b"IDAT", zlib.compress(rows))
        + native._chunk(b"IEND", b""))
    assert Image.open(interlaced).info.get("interlace") == 1
    np.testing.assert_array_equal(native.decode_images([str(interlaced)]),
                                  jdecode([str(interlaced)]))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_round_trips_through_pil(tmp_path, channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (13, 21, channels), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    native.write_png(path, img)
    back = Image.open(path)
    assert back.mode == ("RGBA" if channels == 4 else "RGB")
    np.testing.assert_array_equal(np.asarray(back), img)
    assert png_filters(path) == {0}
    np.testing.assert_array_equal(native.decode_images([path]),
                                  jblender.load_images([path]))
    with pytest.raises(ValueError):
        native.write_png(path, img.astype(np.float32))


# ---------------- Blender, LLFF ----------------


@pytest.mark.parametrize("kw", [dict(white_bkgd=True),
                                dict(n_imgs=5, seed=3),
                                dict(n_imgs=4, white_bkgd=True, downsample=2)])
def test_blender_dataset_matches_jax(blender_root, kw):
    ours = blender.BlenderDataset("minilego", data_root=blender_root, **kw)
    theirs = jblender.BlenderDataset("minilego", data_root=blender_root, **kw)
    for name in ("imgs", "poses", "testimg", "testpose", "path_poses",
                 "aabb"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    assert ours.hwf[:2] == theirs.hwf[:2]
    np.testing.assert_allclose(ours.hwf[2], theirs.hwf[2], rtol=1e-6)
    assert (ours.near, ours.far, ours.ndc) == (theirs.near, theirs.far,
                                               theirs.ndc)


@pytest.mark.parametrize("kw", [dict(), dict(recenter=False),
                                dict(bd_factor=0.5)])
def test_llff_scene_and_dataset_match_jax(llff_root, kw):
    scene_dir = os.path.join(llff_root, "llff", "miniroom")
    ours = llff.load_llff_scene(scene_dir, **kw)
    theirs = jllff.load_llff_scene(scene_dir, **kw)
    np.testing.assert_array_equal(ours["imgs"], theirs["imgs"])
    for name in ("poses", "bounds", "path_poses"):
        np.testing.assert_allclose(ours[name], theirs[name], atol=1e-6,
                                   err_msg=name)
    assert ours["hwf"][:2] == theirs["hwf"][:2]
    np.testing.assert_allclose(ours["hwf"][2], theirs["hwf"][2], rtol=1e-6)
    for ndc in (True, False):
        args = (ours["imgs"], ours["poses"], ours["hwf"],
                float(ours["bounds"].min()), float(ours["bounds"].max()))
        a, b = llff.LLFFDataset(*args, ndc=ndc), jllff.LLFFDataset(*args,
                                                                   ndc=ndc)
        np.testing.assert_allclose([a.near, a.far], [b.near, b.far],
                                   rtol=1e-6)
        np.testing.assert_allclose(a.aabb, b.aabb, rtol=1e-6)


def test_llff_refuses_a_bad_scene(llff_root, tmp_path):
    with pytest.raises(FileNotFoundError):
        llff.load_llff_scene(os.path.join(llff_root, "llff", "miniroom"),
                             factor=4)


# ---------------- Splitter ----------------


def _splitters(kind, roots, **kw):
    data_root, scene = roots.get(kind, ("", ""))
    args = dict(n_training_views=3, data_root=data_root, seed=5, **kw)
    return (splitter.Splitter(kind, scene, **args),
            jsplitter.Splitter(kind, scene, **args))


@pytest.mark.parametrize("kind", ["synthetic", "llff", "sphere", "lattice"])
def test_splitter_matches_jax(kind, blender_root, llff_root):
    roots = {"synthetic": (blender_root, "minilego"),
             "llff": (llff_root, "miniroom")}
    ours, theirs = _splitters(kind, roots, white_bkgd=True)
    ours.split()
    theirs.split()
    for name in ("train_ids", "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    assert len(ours.train_ids) == 3 and len(ours.test_ids) > 0
    exact = kind != "llff"
    for a, b in zip(ours.get_splits(), theirs.get_splits()):
        np.testing.assert_array_equal(a.imgs, b.imgs)
        if exact:
            np.testing.assert_array_equal(a.poses, b.poses)
        else:
            np.testing.assert_allclose(a.poses, b.poses, atol=1e-6)
        assert a.hwf[:2] == b.hwf[:2] and a.ndc == b.ndc == (kind == "llff")
        np.testing.assert_allclose(a.hwf[2], b.hwf[2], rtol=1e-6)
        np.testing.assert_allclose([a.near, a.far], [b.near, b.far],
                                   rtol=1e-6)
        np.testing.assert_allclose(a.aabb, b.aabb, rtol=1e-6)
        assert a.white_bkgd == b.white_bkgd
    np.testing.assert_allclose(ours.path_poses, theirs.path_poses,
                               atol=1e-6)


def test_splitter_refuses_unknown_and_zero_views():
    with pytest.raises(ValueError, match="not supported"):
        splitter.Splitter("voxels", "x")
    sp = splitter.Splitter("sphere", "", n_training_views=0, hw=8)
    with pytest.raises(ValueError, match="greater than zero"):
        sp.split()
