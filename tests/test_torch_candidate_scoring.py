"""The candidate scoring of the batched pairwise registration
(``ops.candidate_scoring``): the CUDA kernel against its plain version.

The plain versions are the registration core's scoring loop and winner step
as they were; the CPU tests show that CPU tensors take them and launch
nothing, and that what the kernel cannot take raises. The tests marked
``card`` skip without a CUDA device and hold the kernel to the plain version
on the card: scores within 1e-5 (the SSIM means sum in another order), -1
and -inf exactly; the winners' shifted crops and masks bit for bit; and on a
16 x 16 grid of the benchmark's generator, every pair's chosen shift equal
and its link quality within ``QUALITY_ATOL``. No test here imports JAX (the
card has none)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch.ops import candidate_scoring as tcs

REPO = Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-5
# the link qualities' tolerance of the registration tests
QUALITY_ATOL = 1e-3
# (shape, region mode): crops whose boxes admit windows 7, 5 and 3 and none,
# in 2D and 3D, in each region mode
BUCKETS = [
    ((22, 102), None), ((22, 102), "union"), ((23, 40), "intersection"),
    ((6, 30), None), ((4, 25), "intersection"), ((2, 17), None),
    ((9, 14, 12), None), ((20, 24, 22), "union"), ((5, 12, 16), "intersection"),
    ((3, 9, 11), None),
]


def _field(rng, shape):
    """A smooth random image (a box blur of noise) in [0, 1)."""
    return ndimage.uniform_filter(rng.random(shape), 3).astype(np.float32)


def _bucket(shape, seed):
    """Four pairs of crops of ``shape`` and 24 candidate shifts each: the
    true shift and its neighbours, no shift, whole-pixel shifts, shifts that
    leave a few rows or under a tenth of the crop, and candidates not kept.
    Pair 1 has NaN borders in both crops, pair 2 in the moving crop only,
    pair 3 a constant moving crop."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    B, C = 4, 24
    big = tuple(s + 8 for s in shape)
    ims0, ims1, ts = [], [], []
    for b in range(B):
        field = _field(rng, big)
        true = rng.uniform(-2.5, 2.5, ndim)
        lo = np.full(ndim, 4)
        im0 = field[tuple(slice(l, l + s) for l, s in zip(lo, shape))]
        moved = ndimage.shift(field, -true, order=1, mode="nearest")
        im1 = moved[tuple(slice(l, l + s) for l, s in zip(lo, shape))].astype(np.float32)
        im1 = im1 + rng.normal(0, 0.01, shape).astype(np.float32)
        im0, im1 = im0.copy(), im1.copy()
        if b == 1:
            im0[..., :2] = np.nan
            im0[:1] = np.nan
            im1[..., -3:] = np.nan
        elif b == 2:
            im1[-1:] = np.nan
            im1[..., :1] = np.nan
        elif b == 3:
            im1[...] = 0.25
        cands = [true, -true, np.zeros(ndim), np.round(true), true + 0.3, true - 0.7]
        for frac in (0.25, 0.5, 0.7, 0.85, 0.95):
            c = np.zeros(ndim)
            c[0] = frac * shape[0] * (1 if b % 2 else -1)
            cands.append(c)
        while len(cands) < C:
            cands.append(rng.uniform(-1, 1, ndim) * np.asarray(shape) * rng.choice([0.1, 0.5, 0.9]))
        ims0.append(im0)
        ims1.append(im1)
        ts.append(np.asarray(cands, np.float32))
    keep = rng.random((B, C)) > 0.15
    keep[:, :3] = True
    return (torch.from_numpy(np.stack(ims0)), torch.from_numpy(np.stack(ims1)),
            torch.from_numpy(np.stack(ts)), torch.from_numpy(keep))


def check_scores(got: torch.Tensor, ref: torch.Tensor) -> None:
    """-inf and -1 where the plain version has them, exactly; the SSIM means
    within SCORE_ATOL."""
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    special = ~np.isfinite(ref) | (ref == -1.0)
    np.testing.assert_array_equal(got[special], ref[special])
    assert np.isfinite(got[~special]).all() and (got[~special] != -1.0).all()
    np.testing.assert_allclose(got[~special], ref[~special], atol=SCORE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,region_mode", BUCKETS[:1] + BUCKETS[6:7])
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(shape, region_mode):
    im0, im1, t, keep = _bucket(shape, 1)
    before = tcs.score_candidates.launches
    scores = tcs.score_candidates(im0, im1, t, keep, region_mode)
    torch.testing.assert_close(scores, tcs.score_candidates_plain(im0, im1, t, keep, region_mode),
                               rtol=0, atol=0)
    assert (scores[~keep] == -torch.inf).all()
    t_best = t[:, 0]
    got = tcs.shift_winners(im0, im1, t_best, region_mode)
    ref = tcs.shift_winners_plain(im0, im1, t_best, region_mode)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
    assert tcs.score_candidates.launches == before


def test_register_on_the_cpu_reports_no_score_launches():
    rng = np.random.default_rng(3)
    ims0 = torch.from_numpy(np.stack([_field(rng, (20, 26)) for _ in range(3)]))
    ims1 = torch.roll(ims0, 2, dims=-1)
    before = tcs.score_candidates.launches
    treg._pcc_register_core_batch(ims0, ims1, 10)
    assert tcs.score_candidates.launches == before


def test_what_the_kernel_cannot_take_raises():
    im = torch.zeros(2, 5, 6)
    t = torch.zeros(2, 3, 2)
    keep = torch.ones(2, 3, dtype=torch.bool)
    tcs._check(im, im, t, 3, keep)  # the kernel's arguments pass
    for args, what in [
        ((im.double(), im.double(), t, 3, keep), "float32"),
        ((im[:, None, None], im[:, None, None], torch.zeros(2, 3, 4), 3, keep), "2D or 3D"),
        ((im, im[:, :4], t, 3, keep), "differ in shape"),
        ((im, im, torch.zeros(2, 3, 3), 3, keep), "do not fit"),
        ((im, im, t, 3, keep.to(torch.uint8)), "boolean"),
        ((im[:, :0], im[:, :0], t, 3, keep), "pixels"),
    ]:
        with pytest.raises(ValueError, match=what):
            tcs._check(*args)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tcs.score_candidates(im.to("meta"), im.to("meta"), t.to("meta"), keep.to("meta"))


def test_the_buckets_cover_every_window_and_rule():
    """The card tests' buckets reach every case the kernel decides: -inf
    (not kept, under a tenth of the moving crop), -1 (no window fits, a
    constant crop) and SSIM means at windows 7, 5 and 3 (read from the plain
    version's boxes)."""
    seen = set()
    for shape, region_mode in BUCKETS:
        im0, im1, t, keep = _bucket(shape, sum(shape))
        scores = tcs.score_candidates_plain(im0, im1, t, keep, region_mode)
        B, C = keep.shape
        im0nm, ui, valid1, lo0, hi0, filled, mask = tcs._pair_terms(im0, im1, region_mode)
        pi = torch.arange(B).repeat_interleave(C)
        im1t = tcs._translate(filled[pi], mask[pi], t.reshape(B * C, -1))
        _, _, lo, hi, _ = tcs._candidate_stats(im1t, im0nm[pi], valid1[pi], ui[pi], lo0[pi],
                                               hi0[pi])
        min_shape = (hi - lo + 1).amin(-1).reshape(B, C)
        win_eff = torch.clamp_max(min_shape - torch.remainder(min_shape - 1, 2), 7)
        means = torch.isfinite(scores) & (scores != -1.0)
        seen |= {f"window {w}" for w in (3, 5, 7) if (means & (win_eff == w)).any()}
        seen |= {"not kept"} if (~keep).any() and (scores[~keep] == -torch.inf).all() else set()
        seen |= {"under a tenth"} if (scores[keep] == -torch.inf).any() else set()
        seen |= {"no window"} if ((scores == -1.0) & (win_eff < 3)).any() else set()
        seen |= {"constant"} if ((scores[3] == -1.0) & (win_eff[3] >= 3)).any() else set()
    assert seen == {"not kept", "under a tenth", "no window", "constant", "window 7",
                    "window 5", "window 3"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape,region_mode", BUCKETS)
def test_kernel_scores_equal_the_plain_version(shape, region_mode):
    dev = _cuda()
    im0, im1, t, keep = (x.to(dev) for x in _bucket(shape, sum(shape)))
    before = tcs.score_candidates.launches
    got = tcs.score_candidates(im0, im1, t, keep, region_mode)
    torch.cuda.synchronize()
    assert tcs.score_candidates.launches == before + 1
    ref = tcs.score_candidates_plain(im0, im1, t, keep, region_mode)
    check_scores(got, ref)
    # the same scores in every run: fixed order, no atomics
    assert torch.equal(tcs.score_candidates(im0, im1, t, keep, region_mode), got)
    # a planted fault, every finite score made 0.1 higher, is caught
    assert torch.isfinite(got).any()
    with pytest.raises(AssertionError):
        check_scores(torch.where(torch.isfinite(got), got + 0.1, got), ref)


@pytest.mark.card
@pytest.mark.parametrize("shape,region_mode", BUCKETS)
def test_kernel_winners_are_bit_equal_to_the_plain_version(shape, region_mode):
    dev = _cuda()
    im0, im1, t, keep = (x.to(dev) for x in _bucket(shape, sum(shape)))
    t_best = t[:, 0].contiguous()
    before = tcs.score_candidates.launches
    got = tcs.shift_winners(im0, im1, t_best, region_mode)
    torch.cuda.synchronize()
    assert tcs.score_candidates.launches == before + 1
    img, mask, frac_ok, box_max = tcs.shift_winners_plain(im0, im1, t_best, region_mode)
    assert torch.equal(torch.isnan(got[0]), torch.isnan(img))
    assert torch.equal(torch.nan_to_num(got[0]).view(torch.int32),
                       torch.nan_to_num(img).view(torch.int32))
    assert torch.equal(got[1], mask) and torch.equal(got[2], frac_ok)
    assert torch.equal(got[3], box_max)


@pytest.mark.card
def test_grid_pairs_choose_the_plain_routes_shifts(monkeypatch):
    """One register() of the benchmark's 16 x 16 grid at one cell seed, with
    the stitch cell's registration arguments, through the kernel and through
    the plain versions: every bucket's shifts and qualities."""
    _cuda()
    from multiview_stitcher_torch import msi_utils
    from portbench import data

    config = json.loads((REPO / "portbench/configs/grid2d_256.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/stitch.json").read_text())
    grid = data.make_grid(config, 2**31 + 7919, "cuda")
    sims = data.to_sims(grid, "affine_metadata")
    rkw = dict(traffic["register_kwargs"])
    tol = traffic["overlap_tolerance_px"] * grid.spacing
    rkw["overlap_tolerance"] = {d: tol for d in grid.sdims}
    captured = []
    core = treg._resample_and_register_batch

    def capture(*args, **kw):
        shifts, qualities = core(*args, **kw)
        captured.append((shifts.cpu(), qualities.cpu()))
        return shifts, qualities

    monkeypatch.setattr(treg, "_resample_and_register_batch", capture)

    def run():
        captured.clear()
        msims = [msi_utils.get_msim_from_sim(s, scale_factors=[]) for s in sims]
        treg.register(msims, transform_key="affine_metadata", new_transform_key="registered",
                      **rkw)
        return list(captured), dict(treg.last_telemetry)

    kernel, telemetry = run()
    assert telemetry["score_launches"] == 2 * telemetry["batches"] > 0
    def plain_scores(*args):
        return tcs.score_candidates_plain(*args)

    plain_scores.launches = tcs.score_candidates.launches
    with monkeypatch.context() as m:
        m.setattr(tcs, "score_candidates", plain_scores)
        m.setattr(tcs, "shift_winners", tcs.shift_winners_plain)
        plain, _ = run()
    assert len(kernel) == len(plain) == telemetry["batches"]
    shifts_k = torch.cat([s for s, _ in kernel])
    shifts_p = torch.cat([s for s, _ in plain])
    assert len(shifts_k) == telemetry["pairs"]
    assert torch.equal(shifts_k, shifts_p)
    q_k = torch.cat([q for _, q in kernel]).numpy()
    q_p = torch.cat([q for _, q in plain]).numpy()
    np.testing.assert_allclose(q_k, q_p, atol=QUALITY_ATOL, rtol=0)
