"""The packed wire's one owner, ``dryv_tpu_torch.wire``, on the CPU: both
entries' blobs of one intra picture share the coefficient segments byte
for byte; ``Staging.grow`` keeps every segment it held; the dense
predicate and ``round_cap`` at their edges; the caps, step keys, retries
and wire bytes each entry reaches on the benchmark's tiny streams
(``avcbench/tests/configs``); and no module but ``wire`` defines the
format."""
import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest

from dryv_tpu_torch import device_ipb_packed, gop_pipeline, graphs, wire
from dryv_tpu_torch.coeffs import KIND_I8
from dryv_tpu_torch.kernels.geometry import BLK, round_up
from dryv_tpu_torch.utils.obs import StageTimers

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "avcbench" / "tests" / "configs"
PACKAGE = ROOT / "dryv_tpu_torch"


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): the caps, retries and wire bytes pinned here are
    a first call's growth, which a kept staging skips."""
    wire.release()
    yield
    wire.release()


class Quiet:
    """The ``timers=`` protocol, keeping nothing."""

    def stage(self, name):
        return contextlib.nullcontext()

    def count(self, name, v):
        pass


def _loads(decode, monkeypatch):
    """Run decode(tm); returns the StageTimers and, per step load, the
    step's key and a copy of the blob it took."""
    seen = []
    load = graphs.Step.load

    def recorded(self, *xs):
        seen.append((self.key, xs[0].numpy().copy()))
        return load(self, *xs)

    monkeypatch.setattr(graphs.Step, "load", recorded)
    tm = StageTimers()
    decode(tm)
    return tm, seen


def _segments(blob, offs):
    return {name: np.ndarray(shape, dt, buffer=blob, offset=off)
            for name, (off, shape, dt) in offs.items()}


@pytest.mark.parametrize("path", ["tiny-ipb/gop_s1.264",
                                  "tiny-intra/idr16_s3.264"])
def test_both_entries_ship_the_same_coefficient_segments(path, monkeypatch):
    """Picture 0 (an IDR picture, CABAC) through the I/P/B entry, and the
    same picture packed by the batched pack alone at the caps the I/P/B
    entry reached: the seven coefficient segments lie at the same
    offsets and hold the same bytes, but for bit 6 of the kind byte,
    which the I/P/B pack sets on every MB with the 8x8 transform (its
    decode masks it off the kind) and the batched pack leaves 0."""
    stream = (CONFIGS / path).read_bytes()
    _, seen = _loads(lambda tm: device_ipb_packed.decode_annexb_device_packed(
        stream, n_threads=1, device_out=True, device="cpu", timers=tm),
        monkeypatch)
    key, ipb_blob = seen[0]
    caps = key[7:10]
    pics, sps, pps = gop_pipeline._parse_pictures(stream)
    n = sps.pic_width_in_mbs * sps.frame_height_in_mbs
    npad = round_up(n, BLK)
    st = wire.Staging(1, npad, n, caps, slots=1)
    batched = gop_pipeline.pack_batch(st, 0, pics[:1], sps, pps, 1,
                                      Quiet()).numpy()
    assert st.caps == caps
    offs, total = wire.layout(1, npad, n, *caps)
    ipb_offs = wire.layout(1, npad, n, *caps, n4=16 * n)[0]
    assert {k: ipb_offs[k] for k in offs} == offs
    assert batched.nbytes == total
    got, ref = _segments(ipb_blob, offs), _segments(batched, offs)
    kind = got["u8"][..., 0].copy()
    t8 = kind >> 6 == 1
    assert (kind[t8] & 0x3F == KIND_I8).all()
    got["u8"][..., 0] &= 0x3F
    for name in offs:
        assert np.array_equal(got[name], ref[name]), name
    assert np.array_equal(t8, ref["u8"][..., 0] == KIND_I8)


def _fill(st, rng):
    """Random bytes in every segment and count of every slot."""
    for b in st.bufs:
        for name, v in b.items():
            if name != "_blob":
                v[...] = rng.integers(-100, 100, v.shape).astype(v.dtype)


@pytest.mark.parametrize("F,n4", [(4, 0), (1, 16 * 40)],
                         ids=["intra", "ipb"])
@pytest.mark.parametrize("grow", [(64, 256, 64), (32, 512, 128)],
                         ids=["W", "ecap-ovcap"])
def test_grow_keeps_every_held_segment(F, n4, grow):
    """After a growth each slot's segments hold the old ones in their
    leading corner; the new room is zero, an overflow slot a pad."""
    n, npad = 40, 128
    st = wire.Staging(F, npad, n, (32, 256, 64), n4=n4, slots=2)
    _fill(st, np.random.default_rng(F))
    old = [{k: v.copy() for k, v in b.items() if k != "_blob"}
           for b in st.bufs]
    st.grow(grow, Quiet())
    assert st.caps == grow
    want = set(wire.layout(F, npad, n, *grow, n4=n4)[0]) | {"cnt", "_blob"}
    for b, before in zip(st.bufs, old):
        assert set(b) == want
        for name, v in before.items():
            corner = tuple(map(slice, v.shape))
            assert np.array_equal(b[name][corner], v), name
            rest = b[name].copy()
            rest[corner] = 0 if name != "ovf_idx" else npad
            assert (rest == (npad if name == "ovf_idx" else 0)).all(), name
    assert st.blob(0).numel() == wire.layout(F, npad, n, *grow, n4=n4)[1]


@pytest.mark.parametrize("maxnz,novf,W,npad,want", [
    (33, 10, 32, 255, False),      # novf * 816 == npad * 32: not over
    (33, 10, 32, 254, True),       # one MB's share under it: over
    (300, 4096, 256, 128, False),  # W is at its largest
    (32, 4096, 32, 128, False),    # no MB over W
    (33, 4096, 32, 128, True),
])
def test_dense_at_its_edges(maxnz, novf, W, npad, want):
    assert bool(wire.dense(maxnz, novf, W, npad)) is want
    # numpy rows give the same answer, element by element
    got = wire.dense(np.array([maxnz, 0]), np.array([novf, 0]), W, npad)
    assert got.tolist() == [want, False]


@pytest.mark.parametrize("x,q,want", [
    (0, 32, 32), (1, 32, 32), (32, 32, 32), (33, 32, 64),
    (1024, 1024, 1024), (1025, 1024, 2048), (64, 64, 64), (257, 256, 512),
])
def test_round_cap_rounds_up_to_the_quantum(x, q, want):
    assert wire.round_cap(x, q) == want
    assert wire.round_cap(np.int64(x), q) == want


# the step keys' caps (W, ecap, ovcap) in order of first use, the counter
# retries, and wire_bytes, as the entries reach them on the tiny streams
CAPS = {
    "tiny-ipb/gop_s1.264": ([(256, 1024, 256)], 1, 3_471_520),
    "tiny-live/live_s2.264": ([(128, 1024, 256)], 1, 2_515_072),
    "tiny-live/live_slices4_s4.264": ([(96, 1024, 256)], 1, 2_449_536),
    "tiny-intra/idr16_s3.264": ([(256, 256, 256)], 16, 4_713_728),
}


@pytest.mark.parametrize("path", sorted(CAPS))
def test_caps_each_entry_reaches(path, monkeypatch):
    stream = (CONFIGS / path).read_bytes()
    if "intra" in path:
        def decode(tm):
            gop_pipeline.decode_annexb_gop_pipelined(
                stream, gop=16, n_threads=2, device="cpu", stacked_out=True,
                timers=tm)
    else:
        def decode(tm):
            device_ipb_packed.decode_annexb_device_packed(
                stream, n_threads=2, device_out=True, device="cpu",
                timers=tm)
    tm, seen = _loads(decode, monkeypatch)
    # both keys hold (W, ecap, ovcap) at 7-9
    caps = list(dict.fromkeys(key[7:10] for key, _ in seen))
    want_caps, retries, wire_bytes = CAPS[path]
    assert caps == want_caps
    assert tm.counters["retries"] == retries
    assert tm.counters["wire_bytes"] == wire_bytes == \
        sum(blob.nbytes for _, blob in seen)


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            out.add("." * node.level + (node.module or ""))
            out.update("." * node.level + a.name for a in node.names)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
    return out


def test_the_entries_import_nothing_of_each_other():
    """The I/P/B entry reads the wire from ``wire``, not from its peer,
    and the batched entry nothing from the I/P/B one."""
    ipb = _imports(PACKAGE / "device_ipb_packed.py")
    batched = _imports(PACKAGE / "gop_pipeline.py")
    assert not {m for m in ipb if "gop_pipeline" in m}, ipb
    assert not {m for m in batched if "device_ipb_packed" in m}, batched
    assert ".wire" in ipb and ".wire" in batched


# names of the format and its staging, and the segment names a table of
# it would list
FORMAT_NAMES = {"SEGMENTS", "_BLOB_SPEC", "_IPB_SPEC", "I16_STRIDE",
                "U8_STRIDE", "layout", "alloc", "_layout", "_alloc",
                "_shapes", "_blob_layout", "_alloc_blob", "round_cap",
                "_round_cap", "dense", "Staging", "BlobStaging", "split",
                "split_blob", "dense_rows", "wire_syntax", "dbctl",
                "dbctl_of", "_dbctl_of"}


def test_only_wire_defines_the_format():
    """No module of the package but ``wire.py`` defines a name of the
    format, its device decode or its staging at module level, or holds
    a table of (segment name, numpy dtype, ...) rows."""
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        defined = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                defined.add(node.name)
            elif isinstance(node, ast.Assign):
                defined.update(t.id for t in node.targets
                               if isinstance(t, ast.Name))
        # rows ("ovf_rows", np.int16, ...)
        rows = [n for n in ast.walk(tree) if isinstance(n, ast.Tuple)
                and len(n.elts) > 1 and isinstance(n.elts[0], ast.Constant)
                and n.elts[0].value == "ovf_rows"
                and isinstance(n.elts[1], ast.Attribute)
                and isinstance(n.elts[1].value, ast.Name)
                and n.elts[1].value.id == "np"]
        if path.name == "wire.py" and path.parent == PACKAGE:
            assert FORMAT_NAMES - {"_BLOB_SPEC", "_IPB_SPEC", "_layout",
                                   "_alloc", "_shapes", "_blob_layout",
                                   "_alloc_blob", "_round_cap",
                                   "BlobStaging", "split_blob",
                                   "_dbctl_of"} <= defined
            assert len(rows) == 1
        else:
            assert not defined & FORMAT_NAMES, (path, defined & FORMAT_NAMES)
            assert not rows, path
