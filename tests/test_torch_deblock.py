"""The port's deblock precompute equals deblock_precompute_intra_jax on
all-intra batches and, for intra and inter pictures,
deblock_precompute_jax and the numpy deblock_precompute; the plain in-place filter (B3's twin) applied after
the plain wavefront equals the Pallas recon + deblock kernels in
interpret mode, and B3's persistent schedule, replayed MB by MB through
the plain per-MB step, gives the plain filter's planes, on intra edge
parameters and on inter ones (bS 1 and 2, changing along an edge)."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.deblock import (deblock, deblock_plain,
                                            deblock_precompute,
                                            deblock_tickets, filter_mbs,
                                            pack_params, pad_planes,
                                            unpad_planes)
from dryv_tpu_torch.kernels.geometry import PRE_KEYS
from dryv_tpu_torch.tables import decoder_tables

from test_pallas_deblock import _random_pre
from test_pallas_wavefront import _random_syntax
from test_torch_wavefront import port_recon


@pytest.mark.parametrize("geom", [(1, 1), (5, 3), (8, 6)])
def test_precompute_matches_jax(geom):
    import jax.numpy as jnp
    from dryv_tpu.kernels.deblock import deblock_precompute_intra_jax

    mb_w, mb_h = geom
    n = mb_w * mb_h
    F = 3
    rng = np.random.default_rng(5 * mb_w + mb_h)
    kind = rng.integers(0, 4, (F, n)).astype(np.int32)
    qp = rng.integers(0, 52, (F, n)).astype(np.int32)
    sid = np.sort(rng.integers(0, 3, (F, n)), axis=1).astype(np.int32)
    dis = rng.integers(0, 3, (F, n)).astype(np.int32)
    offa = (2 * rng.integers(-6, 7, (F, n))).astype(np.int32)
    offb = (2 * rng.integers(-6, 7, (F, n))).astype(np.int32)
    c0, c1 = 2, -3
    got = deblock_precompute(*(torch.from_numpy(a) for a in (
        kind, qp, sid, dis, offa, offb)), mb_w, mb_h, c0, c1,
        decoder_tables("cpu"))
    for f in range(F):
        ref = deblock_precompute_intra_jax(
            *(jnp.asarray(a[f]) for a in (kind, qp, sid, dis, offa, offb)),
            mb_w, mb_h, c0, c1)
        for k in PRE_KEYS:
            np.testing.assert_array_equal(got[k][f].numpy(),
                                          np.asarray(ref[k]), err_msg=k)


def _inter_picture(rng, mb_w, mb_h):
    """Per-MB syntax of a random I/P/B picture (native kinds, intra 0..3
    and 11, inter 4..10) and its motion field: coded flags, small vectors
    so that both sides of the |dv| >= 4 test occur, reference keys -1..2
    per list."""
    n = mb_w * mb_h
    H4, W4 = 4 * mb_h, 4 * mb_w
    kind = rng.choice([0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11], n)
    qp = rng.integers(0, 52, n)
    sid = np.sort(rng.integers(0, 3, n))
    ctl = np.stack([rng.integers(0, 3, 3), 2 * rng.integers(-6, 7, 3),
                    2 * rng.integers(-6, 7, 3)], 1)
    t8 = rng.integers(0, 2, n)
    nz4 = rng.random((H4, W4)) < 0.3
    mv0, mv1 = rng.integers(-6, 7, (2, H4, W4, 2))
    rk0, rk1 = rng.integers(-1, 3, (2, H4, W4))
    return [a.astype(np.int32) for a in (kind, qp, sid, ctl, t8)] + [
        nz4] + [a.astype(np.int32) for a in (mv0, mv1, rk0, rk1)]


def _inter_pre(pics, mb_w, mb_h, c0=2, c1=-3, motion=True):
    """``deblock_precompute`` of a batch of ``_inter_picture``s; without
    `motion` it is given no inter inputs."""
    kind, qp, sid, ctl, t8, nz4, mv0, mv1, rk0, rk1 = [
        np.stack(a) for a in zip(*pics)]
    per_mb = [np.take_along_axis(ctl[..., i], sid, 1) for i in range(3)]
    inter = [torch.from_numpy(a) for a in (t8, nz4, mv0, mv1, rk0, rk1)]
    return deblock_precompute(
        *(torch.from_numpy(a) for a in (kind, qp, sid, *per_mb)),
        mb_w, mb_h, c0, c1, decoder_tables("cpu"), *(inter if motion else ()))


@pytest.mark.parametrize("geom", [(1, 1), (5, 3), (8, 6)])
def test_precompute_inter_matches_jax(geom):
    import jax.numpy as jnp
    from dryv_tpu.kernels.deblock import (deblock_precompute as host_pre,
                                          deblock_precompute_jax)

    mb_w, mb_h = geom
    rng = np.random.default_rng(7 * mb_w + mb_h)
    pics = [_inter_picture(rng, mb_w, mb_h) for _ in range(3)]
    batch = _inter_pre(pics, mb_w, mb_h)
    for f, pic in enumerate(pics):
        kind, qp, sid, ctl, t8, nz4, mv0, mv1, rk0, rk1 = pic
        got = {k: v[f] for k, v in batch.items()}
        ref = deblock_precompute_jax(
            *(jnp.asarray(a) for a in (kind, qp, sid, ctl[sid, 0],
                                       ctl[sid, 1], ctl[sid, 2])),
            mb_w, mb_h, 2, -3, *(jnp.asarray(a) for a in (
                t8, nz4, mv0, mv1, rk0, rk1)))
        host = host_pre(kind, qp, sid, ctl, mb_w, mb_h, 2, -3, t8, nz4, mv0,
                        mv1, rk0, rk1)
        for k in PRE_KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)
    if mb_w > 1:
        assert set(np.unique(got["bsv"].numpy())) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("geom", [(1, 1), (5, 3), (8, 6)])
def test_precompute_ignores_motion_on_intra_pictures(geom):
    """All-intra pictures: the inter inputs (random coded flags, vectors
    and keys) change no parameter, so the batched intra paths may leave
    them out."""
    mb_w, mb_h = geom
    rng = np.random.default_rng(11 * mb_w + mb_h)
    pics = [_inter_picture(rng, mb_w, mb_h) for _ in range(3)]
    for pic in pics:
        pic[0] = rng.choice([0, 1, 2, 3, 11], mb_w * mb_h).astype(np.int32)
        pic[4][:] = 0
    got = _inter_pre(pics, mb_w, mb_h, motion=False)
    want = _inter_pre(pics, mb_w, mb_h)
    for k in PRE_KEYS:
        assert torch.equal(got[k], want[k]), k
    if mb_w > 1:
        assert set(np.unique(got["bsv"].numpy())) == {0, 3, 4}


@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_plain_deblock_matches_pallas(geom, F):
    from dryv_tpu.kernels.pallas_deblock import make_gop_recon_deblock_pallas

    mb_w, mb_h = geom
    rng = np.random.default_rng(31 * mb_w + mb_h)
    s, y_resid, c_resid = _random_syntax(rng, mb_w, mb_h, F)
    pre = _random_pre(rng, s, mb_w, mb_h, F)
    fn = make_gop_recon_deblock_pallas(mb_w, mb_h, F, interpret=True)
    ref = fn(s, y_resid, c_resid, pre)
    y, cb, cr = port_recon(s, y_resid, c_resid, mb_w, mb_h)
    prm = pack_params({k: torch.from_numpy(v) for k, v in pre.items()})
    got = deblock(prm, y, cb, cr, mb_w, mb_h)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _smooth_planes(rng, mb_w, mb_h, F):
    """Planes whose 4x4 blocks step by a few levels, so that most edges
    pass the alpha/beta tests and get filtered."""
    H, W = 16 * mb_h, 16 * mb_w

    def plane(h, w):
        yy, xx = np.mgrid[:h, :w]
        wave = 60 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
        blocks = np.kron(rng.integers(-8, 9, (F, h // 4, w // 4)),
                         np.ones((4, 4), np.int64))
        noise = rng.integers(-2, 3, (F, h, w))
        return torch.from_numpy(np.clip(128 + wave + blocks + noise, 0, 255)
                                .astype(np.uint8))

    return plane(H, W), plane(H // 2, W // 2), plane(H // 2, W // 2)


def _params(rng, which, mb_w, mb_h, F):
    """Packed edge parameters: "all_on" (every edge of the picture's
    interior on, one slice), "slices" (sorted random slice ids with
    disable_deblocking_filter_idc 0/1/2 per MB: bS-0 slice edges and
    whole MBs left unfiltered) or "inter" (random I/P/B pictures through
    ``deblock_precompute``: bS 0..4, changing from one 4-line segment to
    the next along an edge)."""
    n = mb_w * mb_h
    if which == "inter":
        return pack_params(_inter_pre(
            [_inter_picture(rng, mb_w, mb_h) for _ in range(F)], mb_w, mb_h))
    kind = rng.integers(0, 4, (F, n)).astype(np.int32)
    if which == "all_on":
        pre = _random_pre(rng, {"kind": kind}, mb_w, mb_h, F)
        return pack_params({k: torch.from_numpy(v) for k, v in pre.items()})
    qp = rng.integers(10, 52, (F, n)).astype(np.int32)
    sid = np.sort(rng.integers(0, 3, (F, n)), axis=1).astype(np.int32)
    dis = rng.integers(0, 3, (F, n)).astype(np.int32)
    offa = (2 * rng.integers(-6, 7, (F, n))).astype(np.int32)
    offb = (2 * rng.integers(-6, 7, (F, n))).astype(np.int32)
    return pack_params(deblock_precompute(
        *(torch.from_numpy(a) for a in (kind, qp, sid, dis, offa, offb)),
        mb_w, mb_h, 2, -3, decoder_tables("cpu")))


def _replay_b3(prm, y, cb, cr, mb_w, mb_h, n_walkers, seed):
    """B3's persistent schedule, played in Python on the plain per-MB
    step: `n_walkers` resident blocks take ``deblock_tickets`` in order
    and walk their row; each round every walker, in a random order,
    claims a ticket, spins (its MB's ``apron_wait`` on the row above of
    its frame and part is not met), reads and filters its MB's window, or
    stores what it changed and raises its row's flag.  Reading and
    storing are separate turns, so other walkers act in between, as they
    do on the card.  As the kernel does, it takes the MB's own samples
    when the walker reaches the MB before (its prefetch) and its left
    strip from the MB it stored last: the replay asserts that both are
    still what the planes hold when the MB is read."""
    from dryv_tpu_torch.kernels.wavefront import apron_wait

    F = y.shape[0]
    Y, C = pad_planes(y, cb, cr)

    def own(part, f, x, yy):
        if part == "luma":
            return Y[f, 4 + 16 * yy:20 + 16 * yy, 4 + 16 * x:20 + 16 * x] \
                .clone()
        return C[f, :, 2 + 8 * yy:10 + 8 * yy, 2 + 8 * x:10 + 8 * x].clone()

    def left(part, f, x, yy):   # the columns MB (x, y) reads on its left
        if part == "luma":
            return Y[f, 4 + 16 * yy:20 + 16 * yy, 16 * x:4 + 16 * x].clone()
        return C[f, :, 2 + 8 * yy:10 + 8 * yy, 8 * x:2 + 8 * x].clone()

    rng = np.random.default_rng(seed)
    tickets = deblock_tickets(mb_h, F)
    assert sorted(tickets) == sorted((f, yy, p) for f in range(F)
                                     for yy in range(mb_h)
                                     for p in ("luma", "chroma"))
    flags = {}
    walkers = [None] * n_walkers
    nxt = 0
    live = list(range(n_walkers))
    while live:
        moved = False
        for w in rng.permutation(live):
            st = walkers[w]
            if st is None:
                if nxt == len(tickets):
                    live.remove(w)
                else:
                    f, yy, part = tickets[nxt]
                    nxt += 1
                    walkers[w] = {"task": (f, yy, part), "x": 0,
                                  "pending": None, "left": None,
                                  "own": {x: own(part, f, x, yy)
                                          for x in range(min(2, mb_w))}}
                moved = True
                continue
            f, yy, part = st["task"]
            x = st["x"]
            if st["pending"] is None:
                need = apron_wait(x, yy, mb_w)
                if need is not None and flags.get((part, f, yy - 1),
                                                  0) < need:
                    continue                                   # spins
                assert torch.equal(own(part, f, x, yy), st["own"].pop(x)), \
                    ("own samples changed after the prefetch", f, x, yy)
                if x > 0:
                    assert torch.equal(left(part, f, x, yy), st["left"]), \
                        ("left strip changed", f, x, yy)
                st["pending"] = filter_mbs(
                    prm, Y, C, torch.tensor([f]),
                    torch.tensor([yy * mb_w + x]), mb_w, part)
            else:
                plane, idx, val = st["pending"]
                plane[idx] = val
                st["pending"] = None
                flags[(part, f, yy)] = x + 1
                if x + 1 == mb_w:
                    walkers[w] = None
                else:
                    st["x"] = x + 1
                    st["left"] = left(part, f, x + 1, yy)
                    if x + 2 < mb_w:
                        st["own"][x + 2] = own(part, f, x + 2, yy)
            moved = True
        assert moved, "deadlock"
    assert all(flags[(p, f, yy)] == mb_w for f, yy, p in tickets)
    return unpad_planes(Y, C)


@pytest.mark.parametrize("n_walkers", [1, 3, 132])
@pytest.mark.parametrize("params", ["all_on", "slices", "inter"])
@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_b3_schedule_replay_matches_plain(geom, F, params, n_walkers):
    mb_w, mb_h = geom
    rng = np.random.default_rng(97 * mb_w + mb_h)
    planes = _smooth_planes(rng, mb_w, mb_h, F)
    prm = _params(rng, params, mb_w, mb_h, F)
    want = deblock_plain(prm, *planes, mb_w, mb_h)
    if mb_w > 1:
        assert not torch.equal(want[0], planes[0])
        assert not torch.equal(want[1], planes[1])
    got = _replay_b3(prm, *planes, mb_w, mb_h, n_walkers,
                     seed=mb_w * n_walkers + F)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_deblock_tickets_start_every_frame_and_part_first():
    assert deblock_tickets(2, 2) == [
        (0, 0, "luma"), (0, 0, "chroma"), (1, 0, "luma"), (1, 0, "chroma"),
        (0, 1, "luma"), (0, 1, "chroma"), (1, 1, "luma"), (1, 1, "chroma")]
