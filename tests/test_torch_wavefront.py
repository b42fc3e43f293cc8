"""The plain intra wavefront (B2's twin) equals the Pallas whole-GOP
kernel make_gop_recon_pallas in interpret mode on random legal syntax,
PCM included."""
import numpy as np
import pytest
import torch

from dryv_tpu_torch.kernels.geometry import Q2SP, Z2SP
from dryv_tpu_torch.kernels.wavefront import intra_recon, recon_inputs
from dryv_tpu_torch.tables import decoder_tables

from test_pallas_wavefront import _random_syntax


def port_recon(s, y_resid, c_resid, mb_w, mb_h, tables=None, halo=None):
    """Spatial residual tiles as the Pallas recon takes them -> planes
    through stage A's clamp to B2's int16 rows, recon_inputs and
    intra_recon (B2b with `halo`) on the CPU."""
    from dryv_tpu.coeffs import KIND_I8

    F, n = s["kind"].shape
    sp = y_resid.reshape(F, n, 256)
    y_z = np.where((s["kind"] == KIND_I8)[..., None], sp[..., Q2SP],
                   sp[..., Z2SP])
    st = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}
    st["pcm_y"] = st["pcm_y"].reshape(F, n, 256)
    meta, yres, cres = recon_inputs(
        st, *(torch.from_numpy(r).clamp(-255, 255).to(torch.int16)
              for r in (y_z, c_resid)))
    return intra_recon(meta, yres, cres, tables or decoder_tables("cpu"),
                       mb_w, mb_h, halo=halo)


@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_plain_wavefront_matches_pallas(geom, F):
    from dryv_tpu.kernels.pallas_wavefront import make_gop_recon_pallas

    mb_w, mb_h = geom
    rng = np.random.default_rng(7 * mb_w + mb_h)
    s, y_resid, c_resid = _random_syntax(rng, mb_w, mb_h, F)
    recon = make_gop_recon_pallas(mb_w, mb_h, F, interpret=True)
    ref = recon(s, y_resid, c_resid)
    got = port_recon(s, y_resid, c_resid, mb_w, mb_h)
    for g, r in zip(got, ref):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _simulate_rows(mb_w, mb_h, F, n_blocks, halo, seed):
    """B2's persistent schedule, played in Python: `n_blocks` resident
    blocks take tickets in order (``row_tickets``) and walk their row;
    each round every block, in a random order, either claims a ticket,
    spins (its MB's ``apron_wait`` is not met) or reconstructs one MB.
    Asserts that every apron an MB reads is finished when it reads it
    (on row 0, with `halo`, every above apron is the halo's), and that
    some block moves in every round."""
    from dryv_tpu_torch.kernels.wavefront import apron_wait, row_tickets

    rng = np.random.default_rng(seed)
    tickets = row_tickets(mb_h, F)
    assert sorted(tickets) == [(f, y) for f in range(F) for y in range(mb_h)]
    flags = np.zeros((F, mb_h), np.int64)
    done = np.zeros((F, mb_h, mb_w), bool)
    task = [None] * n_blocks
    nxt = 0
    live = list(range(n_blocks))
    halo_reads = 0
    while live:
        moved = False
        for b in rng.permutation(live):
            if task[b] is None:
                if nxt == len(tickets):
                    live.remove(b)
                else:
                    task[b] = [*tickets[nxt], 0]
                    nxt += 1
                moved = True
                continue
            f, y, x = task[b]
            need = apron_wait(x, y, mb_w)
            if need is not None and flags[f, y - 1] < need:
                continue                                   # spins
            for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)):
                xx, yy = x + dx, y + dy
                if 0 <= xx < mb_w and yy >= 0:
                    assert done[f, yy, xx], (f, x, y, dx, dy)
                elif 0 <= xx < mb_w and yy == -1:
                    assert need is None      # no wait: the halo is complete
                    halo_reads += halo
            done[f, y, x] = True
            flags[f, y] = x + 1
            task[b] = None if x + 1 == mb_w else [f, y, x + 1]
            moved = True
        assert moved, "deadlock"
    assert done.all()
    assert halo_reads == (F * (3 * mb_w - 2) if halo else 0)


@pytest.mark.parametrize("n_blocks", [1, 3, 132])
@pytest.mark.parametrize("geom,F,halo", [((120, 68), 1, False),
                                         ((120, 68), 4, False),
                                         ((120, 68), 16, False),
                                         ((120, 17), 4, False),
                                         ((120, 17), 4, True),
                                         ((1, 1), 1, False)])
def test_row_schedule_reads_finished_aprons(geom, F, halo, n_blocks):
    _simulate_rows(*geom, F, n_blocks, halo, seed=F * n_blocks)


def test_row_tickets_start_every_frame_first():
    from dryv_tpu_torch.kernels.wavefront import apron_wait, row_tickets

    assert row_tickets(3, 2) == [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2),
                                 (1, 2)]
    assert [apron_wait(x, 1, 4) for x in range(4)] == [2, 3, 4, 4]
    assert apron_wait(5, 0, 8) is None
