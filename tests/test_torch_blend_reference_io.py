"""Port parity: the .blend reader and the ground truth it extracts
(``io/blendfile.py``, ``synth/blend_oracle.py``), the reference-pickle
loader (``io/reference_pickle.py``), ``cli/capture.py`` and
``cli/video_server.py`` — numpy / standard-library code that runs the same
in both packages.

Every input is written here: a small .blend container (header, a DNA1
block with NAME/TYPE/TLEN/STRC, SC, OB (``OBCamera`` with location
F-curves, ``OBCircle``), CA and ME blocks with a ``CustomDataLayer`` of
type 0 (vertex positions), then ENDB), a pickle of the reference's
``KeyPoint`` class from a stub module, and a scene dict built by hand.
Tolerance: every result equal exactly (the same numpy code on the same
input), rendered frames and PNG bytes included.  The video-server tests
are tests/test_pipeline_checkpoint.py's three, against the port.
"""
import pickle
import re
import struct
import sys
import threading
import time
import types

import numpy as np
import pytest

from _torch_threads import _one_thread  # noqa: F401
from photogrammetry_tpu.cli import capture as jcapture
from photogrammetry_tpu.io import blendfile as jblend
from photogrammetry_tpu.io import reference_pickle as jpickle
from photogrammetry_tpu.synth import blend_oracle as joracle
from photogrammetry_tpu_torch.cli import capture
from photogrammetry_tpu_torch.io import blendfile
from photogrammetry_tpu_torch.io import reference_pickle
from photogrammetry_tpu_torch.synth import blend_oracle

SCALAR = {"char": "b", "short": "h", "int": "i", "float": "f"}


class _BlendWriter:
    """A little-endian, 8-byte-pointer .blend writer: SDNA structs
    declared field by field, blocks of packed struct data, then the DNA1
    and ENDB blocks."""

    def __init__(self):
        self.types = ["char", "short", "int", "float", "void"]
        self.tlen = [1, 2, 4, 4, 0]
        self.names, self.strc, self.layout, self.blocks = [], [], {}, []
        self.next_addr = 0x1000

    def _type(self, name):
        if name not in self.types:
            self.types.append(name)
            self.tlen.append(0)
        return self.types.index(name)

    def define(self, name, fields):
        """fields: (type, decorated name) pairs; returns the SDNA index."""
        off, lay, out = 0, {}, []
        for tname, dname in fields:
            ptr = dname.startswith("*")
            dims = [int(x) for x in re.findall(r"\[(\d+)\]", dname)]
            bare = re.match(r"\**(\w+)", dname).group(1)
            ti = self._type(tname)
            unit = 8 if ptr else self.tlen[ti]
            lay[bare] = (off, tname, ptr, dims)
            if dname not in self.names:
                self.names.append(dname)
            out.append((ti, self.names.index(dname)))
            off += unit * int(np.prod(dims or [1]))
        ti = self._type(name)
        self.tlen[ti] = off
        self.layout[name] = lay
        self.strc.append((ti, out))
        return len(self.strc) - 1

    def pack(self, sname, /, **vals) -> bytes:
        buf = bytearray(self.tlen[self.types.index(sname)])
        for key, v in vals.items():
            off, tname, ptr, dims = self.layout[sname][key]
            if ptr:
                struct.pack_into("<Q", buf, off, v)
            elif isinstance(v, (bytes, bytearray)):       # embedded struct
                buf[off:off + len(v)] = v
            elif isinstance(v, str):
                buf[off:off + len(v)] = v.encode()
            else:
                arr = np.ravel(v)
                struct.pack_into("<" + SCALAR[tname] * len(arr), buf, off,
                                 *arr.tolist())
        return bytes(buf)

    def block(self, code, data, sdna=0, count=1):
        addr = self.next_addr
        self.next_addr += 0x100
        self.blocks.append((code, data, addr, sdna, count))
        return addr

    def _dna(self) -> bytes:
        def strings(tag, items):
            out = tag + struct.pack("<I", len(items)) + b"".join(
                s.encode() + b"\0" for s in items)
            return out + b"\0" * (-len(out) % 4)

        out = b"SDNA" + strings(b"NAME", self.names) \
            + strings(b"TYPE", self.types)
        tl = b"TLEN" + struct.pack(f"<{len(self.tlen)}H", *self.tlen)
        out += tl + b"\0" * (-len(tl) % 4)
        out += b"STRC" + struct.pack("<I", len(self.strc))
        for ti, fields in self.strc:
            out += struct.pack("<HH", ti, len(fields))
            out += b"".join(struct.pack("<HH", *f) for f in fields)
        return out

    def write(self, path):
        out = b"BLENDER-v306"
        for code, data, addr, sdna, count in self.blocks + [
                (b"DNA1", self._dna(), 0x10, 0, 1)]:
            out += code + struct.pack("<IQII", len(data), addr, sdna, count)
            out += data
        out += b"ENDB" + struct.pack("<IQII", 0, 0, 0, 0)
        with open(path, "wb") as fh:
            fh.write(out)


def _star(n=15, r_out=1.0, r_in=0.45):
    th = np.arange(2 * n) * np.pi / n
    r = np.where(np.arange(2 * n) % 2 == 0, r_out, r_in)
    return np.stack([r * np.cos(th), r * np.sin(th), np.zeros(2 * n)], 1)


@pytest.fixture(scope="module")
def blend_path(tmp_path_factory):
    w = _BlendWriter()
    w.define("ID", [("char", "name[66]")])
    w.define("ListBase", [("void", "*first"), ("void", "*last")])
    w.define("RenderData", [("int", "sfra"), ("int", "efra"),
                            ("int", "xsch"), ("int", "ysch"),
                            ("short", "size")])
    sc = w.define("Scene", [("ID", "id"), ("RenderData", "r")])
    ob = w.define("Object", [("ID", "id"), ("AnimData", "*adt"),
                             ("float", "loc[3]"), ("float", "rot[3]"),
                             ("float", "size[3]")])
    ad = w.define("AnimData", [("bAction", "*action")])
    ac = w.define("bAction", [("ID", "id"), ("ListBase", "curves")])
    w.define("BezTriple", [("float", "vec[3][3]"), ("char", "ipo"),
                           ("char", "pad[3]")])
    fcs = w.define("FCurve", [("FCurve", "*next"), ("FCurve", "*prev"),
                              ("BezTriple", "*bezt"), ("char", "*rna_path"),
                              ("int", "array_index"), ("int", "totvert")])
    ca = w.define("Camera", [("ID", "id"), ("float", "lens"),
                             ("float", "sensor_x"), ("float", "sensor_y"),
                             ("char", "sensor_fit")])
    w.define("CustomDataLayer", [("int", "type"), ("void", "*data")])
    w.define("CustomData", [("CustomDataLayer", "*layers"),
                            ("int", "totlayer")])
    me = w.define("Mesh", [("ID", "id"), ("int", "totvert"),
                           ("CustomData", "vdata")])
    mv = w.define("MVert", [("float", "co[3]"), ("char", "flag")])

    w.block(b"SC\0\0", w.pack("Scene", id=w.pack("ID", name="SCScene"),
                              r=w.pack("RenderData", sfra=1, efra=9,
                                       xsch=1920, ysch=1080, size=50)), sc)
    # F-curves: location x a bezier ease 0 -> 1 over frames 1-9 (handles
    # that overshoot the segment, which Blender's correction scales
    # back), location z constant, rotation z linear
    path_loc = w.block(b"DATA", b"location\0")
    path_rot = w.block(b"DATA", b"rotation_euler\0")
    bt = [np.array([[[-2.0, 0.0, 0], [1, 0, 0], [6.5, 0, 0]],
                    [[3.5, 1.0, 0], [9, 1, 0], [12, 1, 0]]]),
          np.array([[[0, 6.2, 0], [1, 6.2, 0], [2, 6.2, 0]],
                    [[8, 6.2, 0], [9, 6.2, 0], [10, 6.2, 0]]]),
          np.array([[[0, 0.0, 0], [1, 0, 0], [2, 0, 0]],
                    [[8, 0.1, 0], [9, 0.1, 0], [10, 0.1, 0]]])]
    ipos = [2, 0, 1]
    bez = [w.block(b"DATA", b"".join(w.pack("BezTriple", vec=v, ipo=ipos[i])
                                     for v in b), 0, 2)
           for i, b in enumerate(bt)]
    fc_addrs = [w.next_addr + 0x100 * i for i in range(3)]
    specs = [(path_loc, 0), (path_loc, 2), (path_rot, 2)]
    for i, (rna, idx) in enumerate(specs):
        w.block(b"DATA", w.pack(
            "FCurve", next=fc_addrs[i + 1] if i < 2 else 0,
            prev=fc_addrs[i - 1] if i else 0, bezt=bez[i], rna_path=rna,
            array_index=idx, totvert=2), fcs)
    act = w.block(b"AC\0\0", w.pack(
        "bAction", id=w.pack("ID", name="ACPan"),
        curves=w.pack("ListBase", first=fc_addrs[0], last=fc_addrs[2])), ac)
    adt = w.block(b"DATA", w.pack("AnimData", action=act), ad)
    w.block(b"OB\0\0", w.pack("Object", id=w.pack("ID", name="OBCamera"),
                              adt=adt, loc=[0.0, 0.0, 6.2],
                              rot=[0.0, 0.0, 0.0], size=[1, 1, 1]), ob)
    w.block(b"OB\0\0", w.pack("Object", id=w.pack("ID", name="OBCircle"),
                              adt=0, loc=[0.1, -0.2, 0.0],
                              rot=[0.0, 0.0, 0.3], size=[1.5, 1.5, 1.0]), ob)
    w.block(b"CA\0\0", w.pack("Camera", id=w.pack("ID", name="CACamera"),
                              lens=50.0, sensor_x=36.0, sensor_y=24.0,
                              sensor_fit=0), ca)
    star = _star()
    co = np.concatenate([star, star[:4]])      # duplicates, as in a mesh
    verts = w.block(b"DATA", b"".join(w.pack("MVert", co=c) for c in co),
                    mv, len(co))
    other = w.block(b"DATA", b"\0" * 16)
    layers = w.block(b"DATA", w.pack("CustomDataLayer", type=5, data=other)
                     + w.pack("CustomDataLayer", type=0, data=verts),
                     0, 2)
    w.block(b"ME\0\0", w.pack(
        "Mesh", id=w.pack("ID", name="MECircle"), totvert=len(co),
        vdata=w.pack("CustomData", layers=layers, totlayer=2)), me)
    path = tmp_path_factory.mktemp("blend") / "scene.blend"
    w.write(path)
    return str(path)


def test_blendfile_reads_the_same_catalogue(blend_path):
    a, b = blendfile.BlendFile(blend_path), jblend.BlendFile(blend_path)
    assert (a.psize, a.endian, a.version) == (b.psize, b.endian,
                                               b.version) == (8, "<", "306")
    assert a.structs.keys() == b.structs.keys()
    for name, s in a.structs.items():
        t = b.structs[name]
        assert (s.name, s.size) == (t.name, t.size)
        assert {k: tuple(f) for k, f in s.fields.items()} == \
            {k: tuple(f) for k, f in t.fields.items()}
    assert [tuple(x) for x in a.blocks] == [tuple(x) for x in b.blocks]
    assert {k: tuple(v) for k, v in a.by_addr.items()} == \
        {k: tuple(v) for k, v in b.by_addr.items()}
    assert a.structs["Object"].fields["loc"].shape == (3,)
    assert a.structs["FCurve"].fields["next"].is_pointer
    ob = a.find_blocks(b"OB\0\0")[0]
    assert a.read_field(ob.offset, a.struct_of_block(ob), "id.name") == \
        "OBCamera"


def test_extract_blend_scene_equal(blend_path):
    got = blend_oracle.extract_blend_scene(blend_path)
    ref = joracle.extract_blend_scene(blend_path)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), key)
    assert got["image_size"] == (540, 960)
    assert got["star_points"].shape == (30, 3)
    assert got["frame_numbers"].tolist() == list(range(1, 10))
    # the bezier ease ends where its keys do; z stays constant
    np.testing.assert_allclose(got["centers"][[0, -1], 0], [0.0, 1.0])
    np.testing.assert_allclose(got["centers"][:, 2], 6.2, rtol=1e-6)


def test_fcurve_helpers_equal_on_random_input():
    rng = np.random.default_rng(0)
    for _ in range(50):
        x0, x3 = sorted(rng.uniform(0, 100, 2))
        p0 = (x0, rng.normal())
        p3 = (x3, rng.normal())
        p1 = (x0 + rng.uniform(0, 1.2) * (x3 - x0), rng.normal())
        p2 = (x3 - rng.uniform(0, 1.2) * (x3 - x0), rng.normal())
        assert blend_oracle._correct_bezpart(p0, p1, p2, p3) == \
            joracle._correct_bezpart(p0, p1, p2, p3)
        x = rng.uniform(x0, x3)
        assert blend_oracle._bezier_value(p0, p1, p2, p3, x) == \
            joracle._bezier_value(p0, p1, p2, p3, x)
        ang = rng.uniform(-np.pi, np.pi, 3)
        np.testing.assert_array_equal(blend_oracle._euler_xyz_matrix(*ang),
                                      joracle._euler_xyz_matrix(*ang))


def _scene_dict():
    """A blend scene by hand: the star at z = 0, a 4-frame pan at z = 6.2
    looking down, the 50 mm / 36 mm camera at 1920x1080."""
    star = _star()
    centers = np.stack([[0.25 * i, 0.0, 6.2] for i in range(4)])
    r = np.diag([1.0, -1.0, -1.0])
    f = 50.0 / 36.0 * 1920
    k = np.array([[f, 0, 960.0], [0, f, 540.0], [0, 0, 1]])
    return dict(centers=centers, rs=np.stack([r] * 4),
                ts=np.stack([-r @ c for c in centers]), k=k,
                image_size=(1080, 1920), star_points=star)


@pytest.mark.parametrize("texture", [True, False])
def test_render_and_orbit_bit_equal(texture):
    scene = _scene_dict()
    for make in (lambda m: m.render_blend_sequence(scene, scale=0.1,
                                                   texture=texture),
                 lambda m: m.render_blend_sequence(
                     m.orbit_blend_scene(scene, num_frames=5,
                                         total_angle=0.6),
                     scale=0.1, texture=texture)):
        got, ref = make(blend_oracle), make(joracle)
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(ref[key]), key)
        assert got["frames"].dtype == np.uint8
        assert got["frames"].shape[1:] == (108, 192)
        assert (got["frames"] == 255).any()


@pytest.fixture
def keypoint_module(monkeypatch):
    """The reference's ``photogrammetry.models.keypoint`` as a stub module
    with its ``KeyPoint`` class, and one class no loader may resolve."""
    mods = {}
    for name in ("photogrammetry", "photogrammetry.models",
                 "photogrammetry.models.keypoint"):
        mods[name] = types.ModuleType(name)
        monkeypatch.setitem(sys.modules, name, mods[name])
    kp_mod = mods["photogrammetry.models.keypoint"]

    class KeyPoint:
        pass

    class Other:
        pass

    for cls in (KeyPoint, Other):
        cls.__module__ = kp_mod.__name__
        cls.__qualname__ = cls.__name__
        setattr(kp_mod, cls.__name__, cls)
    return kp_mod


def _dump(objs, path):
    # protocol 3 names numpy's scalar by module path in text: written the
    # way numpy 1.x, which pickled the reference's files, names it
    raw = pickle.dumps(objs, protocol=3)
    with open(path, "wb") as fh:
        fh.write(raw.replace(b"numpy._core.multiarray", b"numpy.core.multiarray"))


def test_reference_pickle_loads_the_same(keypoint_module, tmp_path):
    rng = np.random.default_rng(3)
    kps = []
    for i in range(5):
        kp = keypoint_module.KeyPoint()
        kp.coord = [int(x) for x in rng.integers(0, 640, 2)]
        kp.moment = np.float64(rng.normal()) if i % 2 else float(i)
        kp.descriptor = int(rng.integers(0, 2 ** 62)) << 190 | i
        kps.append(kp)
    path = tmp_path / "kp.dat"
    _dump(kps, path)
    got = reference_pickle.load_reference_keypoints(str(path))
    ref = jpickle.load_reference_keypoints(str(path))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    coords, bits, moments = got
    assert coords.shape == (5, 2) and bits.shape == (5, 256)
    assert bits[3, 0] == 1 and bits[3, 1] == 1 and bits[4, 2] == 1

    bad = tmp_path / "bad.dat"
    _dump([keypoint_module.Other()], bad)
    for mod in (reference_pickle, jpickle):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            mod.load_reference_keypoints(str(bad))


def test_capture_synthetic_png_equal(tmp_path, capsys):
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    args = ["--synthetic", "--width", "160", "--height", "120"]
    assert capture.main([str(a), *args]) == 0
    assert jcapture.main([str(b), *args]) == 0
    assert a.read_bytes() == b.read_bytes()
    from PIL import Image

    assert np.asarray(Image.open(a)).shape == (60, 80)
    assert "synthetic" in capsys.readouterr().out


def test_frame_buffer_handoff():
    from photogrammetry_tpu_torch.cli.video_server import FrameBuffer

    buf = FrameBuffer()
    got = []

    def reader():
        got.append(buf.read())

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.05)
    buf.write(b"jpeg-bytes")
    t.join(timeout=2)
    assert got == [b"jpeg-bytes"]


def test_synthetic_stream_yields_jpeg():
    from photogrammetry_tpu_torch.cli.video_server import synthetic_frames

    frame = next(synthetic_frames(fps=1000.0))
    assert frame[:2] == b"\xff\xd8"  # JPEG SOI marker


def test_video_feed_route():
    pytest.importorskip("flask")
    from photogrammetry_tpu_torch.cli.video_server import (
        FrameBuffer, make_app,
    )

    buf = FrameBuffer()
    app = make_app(buf)
    client = app.test_client()
    assert client.get("/").status_code == 200

    threading.Timer(0.05, lambda: buf.write(b"\xff\xd8data")).start()
    resp = client.get("/video-feed")
    chunk = next(resp.response)
    assert b"--frame" in chunk and b"\xff\xd8data" in chunk
    resp.close()
