#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

Run from the root of the repository, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, one printed line or block each:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it, and
   whether ``zarr``, ``numcodecs`` or a blosc module imports (in a child
   process: the port's zarr IO needs none of them), whether the readers'
   optional packages import (``h5py``, ``imageio``, ``PIL``, ``zstandard``,
   ``imagecodecs``, ``aicsimageio``; in child processes too), and the C
   compiler the TIFF codecs build with;
2. the build of every CUDA source of the port, timed (nvcc, sm_90a);
3. each kernel against its plain version on the card, on small cases: the
   translation kernels on small layouts (unit scale, uniform z stride 2 and
   per-view scales, a banded ``origin``, uint16 output, views whose z
   validity begins or ends inside a run of planes, tile shapes that are and
   are not multiples of the kernel blocks, tile depths above, at half and
   below the 3D kernel's run of planes, tile heights of one and a half and
   below the 2D kernel's run of rows and of one and a half of its blocks, and
   view lists of 40 slots, which both kernels stage in several passes); the
   exact-affine kernels on the
   reference's test maps, a map that downscales by 4, uint8/uint16/f32
   sources, ``cval`` NaN and 0, a batch that samples a stack through
   ``tile_idx``/``starts`` and an output shape that is no multiple of the
   blocks (identical masks, values within 5e-3 on data in [0, 100)); then the
   cases aimed at the kernels' staged source boxes. 2D: rotations of 47 and
   92 degrees on rows that take 16-byte loads and rows that do not, output
   widths that are and are not multiples of 4, NaN and inf in the source, a
   map that downscales by 4 and a shear whose boxes exceed the shared-memory
   budget beside a map that downscales by 2 and fits, a stack whose windows
   are cut by every edge, invalid items and a source index outside the stack
   between valid ones, and the 5 x 5 weight grids of ``fuse``. 3D, through
   both kernels: rotations of 47, 92, 137 and -133 degrees about y, NaN and
   inf, a steep shear, a stack cut by every face, invalid items, and the 5^3
   weight grids; each exact-affine kernel also on the host-slab route's
   input (uint16 windows, zeros beyond their extents, a padding slot, no
   ``tile_idx``). Each exact-affine line prints how many blocks or runs
   staged their box in shared memory, took the large-footprint route, or
   were filled with ``cval``. Both translation kernels also take int16,
   float64 and boolean tiles and outputs (boolean: equal voxel for voxel),
   and the exact-affine kernels int16 and float64 sources (cast to float32
   on the card); ``fuse`` keeps int16 and float64 views in their dtype on
   both tiers, and boolean views boolean on the translation tier, against
   ``fuse(device="cpu")``; then the ``pyramid:`` lines: the pyramid's block
   means (``ops.pyramid.coarsen_mean``) against their plain version on the
   card and ``msi_utils._coarsen_mean`` on the host, uint8 and uint16, on
   small cases that trim, a leading ``c`` dim, factors up to 4 and the
   largest factor products, then on the six blocks of the benchmark's zarr
   job (level 0 (101, 1306, 1306) uint16 at (1, 2, 2)), each timed beside
   its byte bound and the plain version, the first also on a cold L2 and
   with its host copies each way; then the ``scoring:`` lines: the
   registration's candidate scoring (``ops.candidate_scoring``) at the stitch
   cell's bucket (4 pairs of 22 x 102 overlaps, 48 candidates a pair) and a
   3D one (4 pairs of 20 x 100 x 100, 192 a pair) and the stitch phase's
   nominal overlap (64 x 64 x 12), its scores within 1e-5 of the plain version
   (-1 and -inf exactly) and its winners bit-equal, both launches timed
   beside the larger of their byte and operation bounds and the plain
   versions;
4. the 3D main path through ``fusion.fuse``: 32 x 32 tiles of 64^3 uint16,
   overlap 12, output (64, 1676, 1676) uint16; a cold and a warm call, both
   streamed through banded kernel calls on three CUDA streams (its 537 MB of
   tiles are above ``STREAM_BYTES``), with the streams' busy times, the
   device tile cache emptied before the warm call (the cold call seeds it);
   then the monolithic tier on the same tiles, the cache emptied again, split
   into plan, upload, kernel and download, and held against the streamed
   output; the streamed call once more, every batch gathered from the stack
   the monolithic call cached (0 bytes up, bit-equal); the whole output against
   the plain version, run on the card band by band through ``origin``; the
   kernel's launch on arguments checked once, warm and on a cold L2 (a
   256 MB buffer zeroed before each launch), beside the wrapper's own call;
   the middle band of the streamed run: its launch against the plain
   version on the same checked arguments, and timed;
5. the north star zarr -> zarr: the same 1024 tiles, each written as its own
   zarr v2 array by the port's writer under ``.bench_large/``, opened lazily
   and fused with ``output_chunksize=128`` into an OME-Zarr, cold and warm
   (the device tile cache emptied before each): bands, views a band, batches, bytes each way, the streams' busy times,
   wall time and output Mvox/s; level 0 read back and held against the
   monolithic output of phase 4, the multiscales metadata and every pyramid
   level checked; about 1 GB of disk, removed after the API phase. Then the
   ``link:`` lines (each with the card's name and power limit): the link
   codec (``ops.link_codec``, a library that neither fusion nor registration
   calls) on the same tiles: the host half's rates, native and numpy, on one
   8 MB upload batch; the torch half's times on the card (CUDA events) on
   that batch; ``put_packed`` and ``fetch_packed`` of the 537 MB stack
   beside one pinned copy each way, each round trip bit-equal. Then the
   ``cache:`` lines (each with
   the card's name and power limit), reuse across ``fuse()`` calls from an
   empty device tile cache: the cold streamed call that seeds the cache (the
   seeded entry's bytes) beside one with the cache's budget at 0 (the peak
   device memory of each), the warm repeat from the resident stack (0 bytes
   up, 0 tile reads, every batch a gather, the streams' spans, kernel 1's
   launches), the lazy zarr tiles into a zarr store twice (the repeat reads
   no tile), a pass stopped at its deadline and its retry from the
   upload-resume stash (the stash's bytes on the card, fewer bytes up, the
   stash retired), the monolithic tier cold and again (the repeat's plan
   stage from the plan cache); every output bit-equal to phase 4's, and a
   failed seeding fails the phase. Then the
   ``zarr3:`` lines (each with the card's name and power limit): the same
   tiles into an NGFF 0.5 OME-Zarr (zarr v3), level 0 in chunks of 128 and
   shards of (64, 512, 512), cold and warm, the streaming bands aligned to
   whole shards, every level bit-equal to phase 5's v2 store, the files of
   both stores counted. The API phase follows (lines start with the card's
   name and power limit, then
   ``api:``): ``prepare_block_fusion`` of the lazy zarr tiles into one zarr
   v2 array with ``output_chunksize=512`` (nblocks [1, 4, 4]), the 16 blocks
   split between a creating and an attaching callable and run by
   ``process_batch_using_threads`` on two threads, held within 1 count of
   phase 4's monolithic output, with the blocks' wall time, output Mvox/s
   and ``fuse_translation_3d`` launches; ``fuse(sims=...,
   output_on_backend=True)`` of the in-memory tiles cold and warm (a CUDA
   tensor bit-equal to the default output, the ``DeprecationWarning``
   raised) and through the monolithic tier (its download stage, now a copy
   on the card, beside phase 4's); ``get_greedy_colors`` (2 colours, grid
   neighbours apart) and ``sims_are_far_apart`` of the 1024 tiles,
   ``max_project_sim`` of the device output along z (equal to ``amax``), and
   one zarr tile through ``serialize_zarr_backed_sim`` and back, byte for
   byte. Then the ``slabs:`` lines: four lazy zarr v2 views of (384, 1024,
   1024) uint16 in chunks of 64^3 (3.22 GB, above ``TILES_MAX_BYTES``, which
   is not patched), rotated about y by 0, 45, 90 and 135 degrees, fused with
   chunks of 256 through the batched tier's host slabs and kernel 4, cold
   and warm: output Mvox/s, the warm split (plan, read, pack, upload,
   kernel, blend, download), window bytes read against tile bytes, uploads,
   peak device memory beside the same views fused from memory through the
   device stack, within 1 count of that output and of a (64, 256, 256)
   window fused with ``device="cpu"``, kernel 4 against its plain version on
   the fullest slab batch; the views are removed after. Then the ``shear:``
   lines: four (256, 512, 512) uint16 views of one smooth volume in a row,
   every other one rotated by 0.05 rad in (y, x), fused with
   ``MVS_TPU_SHEAR=1`` set only inside the phase (the shear tier, no kernel
   launched), cold and warm, the plan's passes and the tier's time (CUDA
   events), held within the reference's shear tolerance of the exact
   kernels' output of the same views;
6. the same as 4 for a 2D slide-scan mosaic: 32 x 32 tiles of 512^2 uint16,
   overlap 64; after phase 7's 2D slide scan, the last ``cache:`` line: its
   cold call (caches emptied) and its repeat, the repeat's plan stage from
   the plan cache, bit-equal, kernel 3 launched in both;
7. three affine main paths through ``fusion.fuse``, one per exact-affine
   kernel: four (256, 512, 512) uint16 views rotated about y (y-decoupled
   kernel); a 4 x 4 grid of 256^3 uint16 tiles under affine-resolved
   transforms with every matrix entry coupled (general kernel); a 16 x 16
   slide scan of 1024^2 uint16 tiles, each rotated and scaled a little (2D
   kernel). Each runs cold and warm, the warm call split into plan, upload,
   kernel, blend and download, and is held against the same ``fuse`` with
   the wrappers swapped for their plain versions on the card. The fullest
   batch's data resample is timed warm and on a cold L2, beside the same
   batch's blending-weight launch, its plain version and one ``grid_sample``
   call (a yardstick for time only: its border rule is not the ``cval``
   mask); no block of that batch may take the large-footprint route.
   The cold call leaves the tile stack in the device tile cache; it is
   dropped before the warm call, whose upload stage then measures the
   upload, and a repeat call after it must upload 0 bytes and give the same
   output;
8. the general fusion path through ``fusion.fuse``, each case cold and
   warm, the warm call split into plan, upload, resample (views and
   blending weights), weights (the weights function), reduce (the builtin
   blend or the fusion function) and download, with the five kernels'
   launch counts set to 0 just before it and read just after, and a
   chunk-aligned window held to the same ``fuse`` with ``device="cpu"``
   (1 count on uint16, rtol 1e-4 / atol 1e-3 on float32): content-based
   fusion (``weights.content_based``, a 22 px halo) of the multi-view views
   of phase 7 through the host tier, 100 chunks of 128^3, a central 128^3
   window held; ``max_fusion`` of the 2D slide scan of phase 6 through the
   tiles tier, chunks of 1024^2, its 2048^2 corner held; the affine 3D tile
   grid of phase 7 as float32 with NaN in each tile's outer 8 voxels and in
   one inner 24^3 blob, through the gather route of the batched tier, a
   128^3 window held and no NaN in the output; and small cases
   (``content_based_dct``, a custom fusion function with fusion weights,
   ``interpolation_order=0``, ``trim_overlap=False`` with ``max_fusion``
   and with content-based weights) against ``device="cpu"``. Lines start
   with ``general:``;
9. msims and time (lines start ``multiscale:``, each with the card's name
   and power limit): a light-sheet time-lapse grid, 3 x 3 tiles of
   (128, 512, 512) uint16 over 3 timepoints, overlap 64, cut from one
   band-limited volume, each tile's true position at each t its grid
   position plus an integer drift in [-1, 1] (z) and [-3, 3] (y, x), the
   metadata holding the grid positions without t. The default pyramid of each
   view (``get_msim_from_sim``, on the host); ``register()`` by shortest
   paths three ways (default: level 0; ``registration_binning`` 1 / 2 / 2:
   level 1; ``reg_res_level=2``), each held to the truth per timepoint (level
   0 within 0.25 px, a coarser level within one of its pixels) and to the
   level it must pick, one pair's level-2 registration held to
   ``device="cpu"`` within 1e-3 px per t; ``fuse()`` of the msims into the
   output's pyramid (every level over every t), its time per level and the
   ``fuse_translation_3d`` launches of each (level, t) plan, counted from 0
   just before, each at least 1, and 128^3 windows of levels 0 and 1 at the
   last t within 1 count of ``device="cpu"``; an OME-Zarr leg at t = 0 (the
   nine msims written by ``write_msim_to_ome_zarr`` under ``.bench_large/``,
   reopened lazily, registered at level 1 reading level-1 arrays only, equal
   to the in-memory registration, and fused into an OME-Zarr returned as an
   msim whose level 0 equals the in-memory t = 0 bit for bit; removed after);
   one ``stitch()`` of the time-lapse, within 1 count of ``fuse()``'s level
   0; then the README's Quickstart as written, in 2D: 2 x 2 (c, y, x) tiles
   of (2, 1024, 1024) uint16, drifting by up to 3 px, through the default
   pyramids, ``register()`` by channel 0 and ``fuse()`` of the msims, every
   (level, channel) plan launching ``fuse_translation_2d``, a window held to
   ``device="cpu"``. The content is band-limited noise made on the card from
   a seed. Under 60 s;
10. bead-based multi-view registration (lines start ``beads:``, each with
   the card's name and power limit): four (256, 512, 512) uint16 views of
   one volume of 3000 beads (seeded, at least 12 px inside and 6 px apart,
   gaussian blobs of sigma 1.2 px, amplitude 2000 +- 20 %, background 100,
   noise sigma 10), rotated about y by 0, 47, 92 and 137 degrees about the
   centre and rendered on the card by splatting the beads and
   ``gaussian_filter``; views 1-3 carry a rigid metadata error of 1-2
   degrees and 2-5 px. ``detect_beads`` of each view on the card (recall of
   the beads 4 px inside within half a voxel diagonal at least 98 %; the
   split of upload, filters, mask download and labelling), one view again
   with ``device="cpu"`` (counts within 0.2 %, matched centroids within 1e-3
   px); ``register()`` of the 6 pairs by ``registration_marker_based``
   (rigid, RANSAC within 2 px, ICP), resolved by global optimisation and by
   ``linear_two_pass``, each view's true beads within 0.25 px RMS and 0.5 px
   at most of view 0's; ``fuse()`` of the registered views through the
   exact-affine kernels (launches counted from 0 just before, routes) and a
   central 128^3 window within 1 count of ``device="cpu"``; a 2 x 2 grid of
   64^3 tiles registered with ``use_fused_core=False`` and through a
   thread-pool ``pairwise_executor``, their pair shifts within 1e-3 px of the
   default path's. Under 60 s;
11. multi-view deconvolution (lines start with the card's name and power
   limit, then ``deconv:``): the four registered views of phase 10 fused by
   ``fuse(..., fusion_func=mv_deconv.multi_view_deconvolution)`` with a
   Gaussian PSF of sigma 1.2 px (9^3) for each view that reaches a chunk,
   10 iterations of the efficient Bayesian kernels, chunks of 128^3 with the
   PSF's 4 px halo, through the host tier; cold and warm, the warm call
   split into plan, upload, resample, RL (``reduce``) and download, the five
   kernels' launches counted from 0 just before it (none expected), the
   central chunk-aligned 128^3 window within 1 count of ``device="cpu"``;
   the 99.9th and 99.99th percentiles against the weighted-average
   ``fuse()`` of the same views (the 99.99th held higher: the beads fill
   under 0.1 % of the output); the fullest chunk's RL timed alone with its
   convolutions' share, beside cuDNN's single-channel conv3d of one; small
   cases on 64^3 windows held to ``device="cpu"`` within 1 count
   (INDEPENDENT kernels; INDEPENDENT kernels with ``lambda_reg=1e-3``,
   where 8 ulps of the reference's float32 Tikhonov square root are allowed
   besides, 2^-23 M / lambda each for the window's largest value M;
   ``sample_boundary_erosion_px=2`` at the output's y = 0 face, whose first
   two rows must be 0);
12. ``stitch()`` of the north star's grid: 32 x 32 tiles of 64^3 uint16,
   overlap 12, cut from one band-limited volume (numpy, seeded) at known
   true positions, their metadata origins off by integers in [-1, 1] (z)
   and [-3, 3] (y, x), registered with an overlap tolerance of 1 / 3 / 3 px
   that covers that error; a cold and a warm call, each from an empty
   device tile cache, the warm one split into graph and pruning, crop
   planning, tile upload, pairwise batches (host clock and CUDA events),
   resolution and fuse, with the edge and pair counts, the bytes uploaded
   and the ``fuse_translation_3d`` launches inside it. Held: every pair's
   shift within 1e-3 px of the true one; every tile's offset, resolved by
   shortest paths over that pairwise graph, within 0.25 px of the truth
   after removing the global offset (the default global optimisation's
   error is printed: it stops unconverged on 1024 tiles, in the JAX package
   as in the port); the output equal to ``fuse()`` under the resolved key;
   ``register()`` on the card within 1e-3 px of ``register(device="cpu")``
   on the grid's 4 x 4 corner;
13. registration quality (lines start with the card's name and power limit,
   then ``metrics:``): ``tile_pair_image_metrics`` of phase 12's grid after
   its warm ``stitch()``, pairs from the overlaps under the metadata key,
   scored under the true positions, the metadata, the default ``register()``
   key and the shortest-paths resolution; the batched NCC on the card, the
   five kernels' launches counted from 0 just before it (none expected),
   split into graph and edge geometry, grids, source windows and slabs
   (host) and device time, with the shape buckets and the summary NCC by
   key. Held: the truth's NCC at least 0.999 and above the metadata's; the
   4 x 4 corner within 1e-4 of ``device="cpu"`` per pair, by the batched
   NCC and by the host loop with NCC and SSIM;
14. the readers (lines start with the card's name and power limit, then
   ``readers:``), on files written under ``.bench_large/`` from seeded
   generators and removed after: the native TIFF codecs' build, timed (it
   must take the native route), and the decode rates of the native
   decoders against the Python ones, bit-equal (LZW and PackBits on an 8 MB
   uint16 image, deflate with predictor 2 on 64 MB); a CZI slide scan, 16 x
   16 tiles of 1024^2 uint16 in 2 channels, overlap 102 px, cut from one
   band-limited image, written as raw subblocks (1.07 GB) whose X/Y starts
   are the true positions plus integers in [-3, 3] px, opened lazily by
   ``io.read_mosaic_into_sims`` and ``stitch()``-ed by channel 0, cold and
   warm: the warm split (open, register with its ``last_telemetry``
   stages, fuse; the file's reads by stage), bytes read against the file's
   size, tile bytes uploaded, ``fuse_translation_2d`` launches; held: every
   tile's offset within 0.25 px of the truth, the output bit-equal to
   ``stitch()`` of the same tiles as numpy arrays, a 2048^2 window within 1
   count of ``fuse(device="cpu")``; a multi-view CZI in a Lightsheet Z.1
   layout, four (256, 512, 512) uint16 views of one volume at 0, 90, 180 and
   270 degrees about y (``View`` positions and angles), read by
   ``read_multiview_czi_into_sims`` and fused cold and warm through kernel
   4 (warm split, launches), bit-equal to ``fuse()`` of the same arrays from
   memory under the reader's affines, a 128^3 window within 1 count of
   ``device="cpu"``; a 4 x 4 grid of deflate TIFFs of (64, 512, 512) uint16,
   overlap 64, written by ``write_tiff``, opened lazily by
   ``read_tiff_into_sim`` and fused into an OME-Zarr with chunks of 128,
   cold and warm (rate, streaming telemetry, ``fuse_translation_3d``
   launches), level 0 bit-equal to the same tiles fused from memory, a
   (64, 256, 256) window across the central overlaps within 1 count of
   ``device="cpu"``; and
   small ZSTD1 CZI, Imaris and PNG files where ``zstandard``, ``h5py`` and
   ``imageio`` / ``PIL`` import (else reported as not run, the reader
   raising as the JAX package's does);
15. the mesh phase (lines start with the card's name and power limit, then
   ``mesh:``), in parts beside the phases whose data it reuses:
   ``parallel.mesh.get_mesh()`` logged, then a virtual mesh of four entries
   on cuda:0 (``Mesh([cuda:0] * 4)``). After the API phase, ``fuse(mesh=)``
   of phase 4's grid in memory (kernel 1, one band of whole view-list tiles
   an entry; the grid is one tile deep in z, so three bands are padding)
   bit-equal to phase 4's monolithic output, warm wall times sharded and
   unsharded (a one-entry mesh) in turns, each band's kernel ms; and
   ``utils.profiling.device_trace`` around one warm streamed ``fuse()`` of
   that grid, whose five CUDA ops with the most device time must name
   kernel 1. After phase 6, the same for the 2D scan (kernel 2, four bands),
   and ``max_fusion`` of its 8 x 8 corner through the tiles tier, chunks of
   1024, sharded against unsharded, bit-equal. After each affine main path
   of phase 7, one more warm ``fuse()`` keeps its fullest batches (joined
   until they hold a chunk an entry), which ``parallel.pipeline.
   sharded_fuse_chunks_exact`` fuses over the mesh (kernels 3, 4 and 5),
   bit-equal to the same batch unsharded and within tolerance of the plain
   versions. After the readers, ``register(mesh=)`` of an 8 x 8 grid of
   64^3 tiles cut from one volume, from host crops and from the resident
   stack, within 1e-6 px of the unsharded call; ``get_stage_times()`` after
   a ``stitch()``, carrying the four stage names of the JAX package; and two
   processes on the card (gloo on localhost, torchrun's variables set
   here) running ``multihost_fuse`` of a 4 x 4 grid of zarr tiles into one
   store, byte-equal to one process's;
16. the serving path (lines start with the card's name and power limit,
   then ``service:``), through the port's default device (no ``device=``
   anywhere): phase 14's CZI slide scan written again (16 x 16 tiles of
   1024^2 uint16, 2 channels, 1.07 GB); ``service.Session().load_mosaic``
   of its 256 views, ``register`` by channel 0 (shortest paths,
   ``upsample_factor`` 100) and
   ``fuse_preview``, cold and warm, every registered offset within 0.25 px
   of the truth; ``spec()`` / ``from_spec()`` round trip; ``serve()`` on a
   free loopback port: every chunk of the preview route and one chunk of
   each of four views read over HTTP (through the port's ``zarr_backend``
   HTTP read and by plain GETs, 20 each, median and p95 printed), each
   bit-equal to its sim; ``io.virtual_ngff.VirtualOMEZarr`` over
   ``fuse(..., output_on_backend=True)`` of the registered scan, every chunk
   cut on the card and bit-equal to the output downloaded, one served over
   HTTP by a ``VirtualOMEZarrServer``; ``neuroglancer_state`` and
   ``fusion_plan``; ``fuse_to_zarr`` in process with
   ``FusionOptions(output_chunksize=8192)`` (4 blocks: each block reads every
   tile), within 1 count of ``fuse()``;
   the bytes read from the CZI by step. On the scan's 4 x 4 corner:
   ``register`` over a ``LocalBridge`` within 1e-3 px of the in-process
   call (the default options), and ``fuse_to_zarr`` (blocks of 2048^2) over
   a ``ProcessPoolBridge`` of two workers
   started by spawn on the card (each answers a probe with its device and
   its kernel launches; kernel 2 launched in them), its store byte-equal to
   the in-process store; the worker start-up timed. The five kernels'
   launches are counted from 0 after the file is written and read at the
   phase's end (``service_launches``);
17. a ``kernels`` JSON line: per kernel its launches in the main-path run,
   its time, the plain version's time, its bound and its error, and its
   launches in the beads phase's fuse (``beads_launches``), the
   deconvolution's warm fuse (``deconv_launches``), the metrics' batched
   call (``metrics_launches``), the API phase's block-wise fusion
   (``api_launches``), the ``slabs:`` phase's warm fuse
   (``slab_launches``), the ``readers:`` phase's warm calls on data a
   reader delivered (``readers_launches``) and the mesh phase's sharded
   runs (``mesh_launches``), the service phase (``service_launches``) and
   the calls that read a cache (``cache_launches``: the cache phase's
   repeats and the 3D main path's resident repeat for kernel 1, the 2D main
   path's resident repeat for kernel 2, the affine repeat for kernel 3).

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero without that line; without a CUDA device it exits
non-zero at once. Tolerances: f32 outputs rtol 1e-4, atol 1e-3; uint16
outputs at most 1 count (truncation ties: a single-view pixel fuses to
w*a/w, which f32 may round just below a).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
KEY = "affine_metadata"

# H100 SXM peaks (NVIDIA data sheet), at the card's full power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# f32 operations per covered (output voxel, view) pair, with the per-column
# parts of the hat expansion amortized away: trilinear lerp 7 x 3, z weight
# contraction 5 hats x 3 + 5 x 2, taper and clip 6, accumulation 5
OPS_PER_VOXEL_VIEW_3D = 21 + 25 + 6 + 5
# bilinear lerp 3 x 3, the four hat terms that are not 0 (two multiplies and
# an add each), taper and clip 6, accumulation 5
OPS_PER_VOXEL_VIEW_2D = 9 + 12 + 6 + 5

# exact-affine kernels, f32 operations per output voxel: ndim rows of ndim
# multiplies and ndim adds for the coordinates, and for a voxel inside the
# source 2^ndim - 1 lerps of 4 operations (1 - f, two multiplies, one add)
def exact_ops(ndim, voxels, inside):
    return voxels * 2 * ndim * ndim + inside * (2**ndim - 1) * 4


F32_RTOL, F32_ATOL, UINT_COUNTS = 1e-4, 1e-3, 1
# exact-affine kernel against its plain version, on data in [0, 100)
EXACT_ATOL = 5e-3

# the blocks a zarr job of the benchmark's 3D grid reduces, all at (1, 2, 2):
# level 0 (101, 1306, 1306) uint16 cut into level 1's 512-wide blocks, then
# the one block of level 2 and of level 3
PYRAMID_BLOCKS = ((101, 1024, 1024), (101, 1024, 282), (101, 282, 1024), (101, 282, 282),
                  (101, 652, 652), (101, 326, 326))
# (shape, factors) of the small cases: odd shapes that trim, a leading c dim,
# 2D and 1D data, and the largest factor products (max * n = 2^32 - 1)
PYRAMID_SMALL = (((7, 37, 41), (1, 2, 2)), ((7, 37, 41), (2, 2, 2)), ((7, 37, 41), (1, 2, 3)),
                 ((7, 37, 41), (1, 1, 4)), ((2, 5, 19, 23), (1, 2, 2, 3)),
                 ((3, 33, 47), (1, 3, 2)), ((45, 61), (2, 4)), ((99,), (4,)),
                 ((4, 64, 16), (1, 1, 1)), ((5, 16, 96), (1, 2, 3)), ((5, 16, 128), (2, 1, 4)),
                 ((3, 40, 1030), (1, 2, 5)))
# the candidate scoring's buckets (pairs, crop shape): the stitch cell's
# (4 pairs of 22 x 102 overlaps), a 3D one of 100 x 100 x 20 overlaps and one
# of the stitch phase's nominal overlap (64^3 tiles, overlap 12 along x)
SCORING_BUCKETS = (("2d", 4, (22, 102)), ("3d", 4, (20, 100, 100)),
                   ("3d_grid", 4, (64, 64, 12)))
# f32 operations of the candidate kernel (csrc/candidate_scoring.cu), each add,
# multiply, divide, compare, min or max counted once (it uses no FMA): a
# shifted pixel (a tap coordinate 5 an axis, nan_to_num 3 a tap, a mix 5, the
# mask test 1; 2D 2 axes, 4 taps and 6 mixes, 3D 3, 8 and 14)
SCORE_SHIFT_OPS = {2: 2 * 5 + 4 * 3 + 6 * 5 + 1, 3: 3 * 5 + 8 * 3 + 14 * 5 + 1}
# beyond the shift: the first sweep's counts, boxes and extremes a pixel (3
# NaN tests, 3 counts, 12 box bounds, 4 extremes); staging a halo pixel (two
# nan_to_num and the box maximum's clamp and max); a box pixel of the winners'
# maximum; one pixel's SSIM from its window means and its accumulation
SCORE_SWEEP_OPS, SCORE_STAGE_OPS, SCORE_BOX_OPS, SCORE_SSIM_OPS = 22, 9, 4, 24
# the kernel's tile of box-interior outputs, (z, y, x), by crop dimension
SCORE_TILE = {2: (1, 16, 128), 3: (4, 8, 32)}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def build_all(_build):
    """Build every CUDA source of the port at once, one nvcc each."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        paths = list(ex.map(_build.build, names))
    return names, paths, time.perf_counter() - t0


def max_err(got, ref, np):
    return float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max(initial=0.0))


def within_tol(got, ref, np) -> bool:
    if np.issubdtype(ref.dtype, np.integer):
        return max_err(got, ref, np) <= UINT_COUNTS
    return bool(np.all(np.abs(got - ref) <= F32_ATOL + F32_RTOL * np.abs(ref)))


def small_layout(np, tsi, tcore, ndim, case, rng):
    """Kernel tables of a small translation grid (a copy of the CPU tests'
    layouts): "unit", "scaled" (z scale 2 in 3D) or "per_view" (one view at
    another spacing; z scale 1.25 in 3D); one view has fractional offsets."""
    sdims = ["z", "y", "x"][-ndim:]
    if ndim == 2:
        tile, step, grid, frac = (24, 40), (18, 30), (2, 2), (0.3, 0.7)
    else:
        tile, step, grid, frac = (10, 16, 40), (8, 12, 32), (2, 1, 2), (0.4, 0.3, 0.7)
    sims = []
    for iv, idx in enumerate(np.ndindex(grid)):
        odd = case == "per_view" and iv % 2
        spacing = dict(zip(sdims, [0.8, 0.5, 0.5][-ndim:])) if odd else None
        shape = tuple(int(t * 1.5) for t in tile) if odd else tile
        sims.append(tsi.get_sim_from_array(
            (rng.random(shape) * 900).astype(np.float32), dims=sdims, scale=spacing,
            translation={
                d: float(idx[i] * step[i] + (frac[i] if iv == 1 else 0.0))
                for i, d in enumerate(sdims)
            },
        ))
    osp = tcore.process_output_stack_properties(
        sims, transform_key=KEY,
        output_spacing=dict(zip(sdims, [2.0, 1.5, 1.5][-ndim:])) if case == "scaled" else None,
    )
    osp = {k: {d: (int(v[d]) if k == "shape" else float(v[d])) for d in sdims}
           for k, v in osp.items()}
    scales = tcore._views_output_scales_per_view(sims, osp, sdims) if case == "per_view" else None
    scale_arr = scales if scales is not None else np.asarray(
        tcore._views_output_scale(sims, osp, sdims)
    )
    tables = tcore.translation_kernel_params(
        {"sparams": [np.eye(ndim + 1)] * len(sims)},
        [tsi.get_stack_properties_from_sim(s) for s in sims], osp, sdims, None, 0, scale_arr,
    )
    max_shape = tuple(max(s.data.shape[i] for s in sims) for i in range(ndim))
    tiles = np.stack([
        np.pad(s.data, [(0, m - n) for n, m in zip(s.data.shape, max_shape)], mode="edge")
        for s in sims
    ])
    scale = tuple(float(x) for x in np.max(np.atleast_2d(scale_arr), axis=0))
    if ndim == 3:
        scale = (int(np.ceil(scale[0])),) + scale[1:]
    return tiles, tables, tuple(osp["shape"][d] for d in sdims), scale_arr, scale, scales


def compare_translation(np, torch, fn, plain, label, args, kw):
    """One translation wrapper call against its plain version on the card;
    the largest difference, which must be within the tolerance."""
    got = fn(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.device == args[0].device and tuple(got.shape) == tuple(kw["out_shape"]), got.shape
    assert got.dtype == kw["out_dtype"], (got.dtype, kw["out_dtype"])
    g = got.cpu().numpy().astype(np.float64 if kw["out_dtype"].is_floating_point else np.int64)
    r = ref.cpu().numpy().astype(g.dtype)
    err = max_err(g, r, np)
    # boolean outputs (F2) must agree voxel for voxel
    ok = err == 0 if kw["out_dtype"] == torch.bool else within_tol(g, r, np)
    log(f"  {label}: max_abs_err={err:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel != plain")
    return err


def check_small_cases(np, torch, tsi, tcore, tf):
    """Phase 3: every kernel against its plain version on the card."""
    worst = {2: 0.0, 3: 0.0}
    rng = np.random.default_rng(0)
    # the tiles of fuse() (deeper or taller than these outputs: one run of
    # planes or one block of rows that ends early); 3D depths of one and a half
    # runs of planes and below a run; 2D heights of one and a half runs of 4
    # rows (6), below a run (3) and of one and a half blocks of 64 rows (96)
    tile_shapes = {
        2: [tf.TILE_SHAPE_2D, (32, 128), (20, 50), (6, 32), (3, 40), (96, 48)],
        3: [tf.TILE_SHAPE_3D, (12, 8, 32), (4, 8, 32), (8, 16, 128), (6, 12, 40)],
    }
    for ndim in (2, 3):
        fn = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
        plain = tf.fuse_translation_3d_plain if ndim == 3 else tf.fuse_translation_2d_plain
        for case in ("unit", "scaled", "per_view"):
            tiles, tables, out_shape, scale_arr, scale, scales = small_layout(
                np, tsi, tcore, ndim, case, rng
            )
            for tile_shape in tile_shapes[ndim]:
                view_idx = tcore.tile_view_lists(
                    tables[0], tables[1], np.asarray(scale_arr, np.float64), out_shape, tile_shape
                )
                variants = [("f32", torch.float32, None, out_shape, view_idx)]
                if case == "unit":
                    variants.append(("uint16", torch.uint16, None, out_shape, view_idx))
                    # tiles and outputs in dtypes the kernels do not read or
                    # write: cast on the card (F1)
                    variants += [(n, t, None, out_shape, view_idx)
                                 for n, t in (("int16", torch.int16), ("f64", torch.float64))]
                    # boolean tiles and output (F2): read as float32, written
                    # as "not zero"
                    variants.append(("bool", torch.bool, None, out_shape, view_idx))
                if case == "unit" and view_idx.shape[0] > 1:
                    origin = np.zeros(ndim, np.int32)
                    origin[0] = tile_shape[0]
                    band_shape = (min(tile_shape[0], out_shape[0] - origin[0]),) + out_shape[1:]
                    variants.append(("origin", torch.float32, origin, band_shape, view_idx[1:2]))
                for label, out_dtype, origin, shape, vidx in variants:
                    if out_dtype == torch.bool:
                        src = tiles > np.median(tiles)
                    elif out_dtype in (torch.int16, torch.float64):
                        src = tiles.astype(np.int16 if out_dtype == torch.int16 else np.float64)
                    else:
                        src = tiles
                    args = (
                        torch.from_numpy(src).cuda(), vidx, *tables,
                    )
                    kw = dict(out_shape=shape, tile_shape=tile_shape, K=vidx.shape[-1],
                              out_dtype=out_dtype, origin=origin, scale=scale,
                              scales=None if scales is None else np.asarray(scales, np.float32))
                    err = compare_translation(
                        np, torch, fn, plain, f"{ndim}d {case:8s} {label:6s} tile={tile_shape}",
                        args, kw)
                    worst[ndim] = max(worst[ndim], err)
    for ndim in (2, 3):
        worst[ndim] = max(worst[ndim], check_long_view_lists(np, torch, tsi, tcore, tf, ndim, rng))
    return worst


def check_long_view_lists(np, torch, tsi, tcore, tf, ndim, rng):
    """Phase 3, translation kernels: view lists longer than one pass of staged
    slots (8 in both kernels). Every view of a small layout is repeated ten
    times with its own content and a jittered fractional offset, so a tile
    lists up to 40 views; unit, scaled (3D: z stride 2) and per-view scales,
    f32 and uint16 output, and a band through ``origin``; 2D at a tile height
    of one and a half runs of rows and at the tile of fuse()."""
    worst = 0.0
    fn = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
    plain = tf.fuse_translation_3d_plain if ndim == 3 else tf.fuse_translation_2d_plain
    tile_shapes = [(12, 8, 32)] if ndim == 3 else [(6, 32), tf.TILE_SHAPE_2D]
    for case in ("unit", "scaled", "per_view"):
        tiles, tables, out_shape, scale_arr, scale, scales = small_layout(
            np, tsi, tcore, ndim, case, rng
        )
        reps, V = 10, len(tiles)
        tiles = np.concatenate([tiles * rng.uniform(0.5, 1.0) for _ in range(reps)])
        jitter = rng.uniform(-1.5, 1.5, (reps * V, ndim)).astype(np.float32)
        tables = tuple(np.concatenate([t] * reps) for t in tables)
        tables = (tables[0] + jitter,) + tables[1:]
        if scales is not None:
            scales = np.concatenate([scales] * reps)
            scale_arr = scales
        for tile_shape in tile_shapes:
            view_idx = tcore.tile_view_lists(
                tables[0], tables[1], np.asarray(scale_arr, np.float64), out_shape, tile_shape
            )
            K = view_idx.shape[-1]
            if K <= 32:
                raise AssertionError(f"{ndim}d long lists {case}: K = {K}, expected more than 32")
            variants = [("f32", torch.float32, None, out_shape, view_idx),
                        ("uint16", torch.uint16, None, out_shape, view_idx)]
            if view_idx.shape[0] > 1:
                origin = np.zeros(ndim, np.int32)
                origin[0] = tile_shape[0]
                band_shape = (min(tile_shape[0], out_shape[0] - tile_shape[0]),) + out_shape[1:]
                variants.append(("origin", torch.float32, origin, band_shape, view_idx[1:2]))
            for label, out_dtype, org, shape, vidx in variants:
                args = (torch.from_numpy(tiles).cuda(), vidx, *tables)
                kw = dict(out_shape=shape, tile_shape=tile_shape, K=K, out_dtype=out_dtype,
                          origin=org, scale=scale,
                          scales=None if scales is None else np.asarray(scales, np.float32))
                worst = max(worst, compare_translation(
                    np, torch, fn, plain, f"{ndim}d {case:8s} {label:6s} tile={tile_shape} K={K}",
                    args, kw))
    return worst


def smooth_tile(np, rng, shape, scale=1000.0, sigma=1.5):
    """Microscopy-like synthetic content: band-limited noise as uint16."""
    from scipy.ndimage import gaussian_filter

    d = gaussian_filter(rng.random(shape), sigma)
    d -= d.min()
    return (d * (scale / max(d.max(), 1e-9))).astype(np.uint16)


def grid_sims(np, tsi, ndim, n, tile, overlap, seed):
    """n x n translation grid of uint16 tiles (rolled copies of one smooth
    tile), as the JAX package's bench builds its north-star grid."""
    rng = np.random.default_rng(seed)
    base = smooth_tile(np, rng, (tile,) * ndim)
    step = tile - overlap
    sdims = ["z", "y", "x"][-ndim:]
    sims = []
    for iy in range(n):
        for ix in range(n):
            data = np.ascontiguousarray(np.roll(base, (iy * 7 + ix * 3) % tile, axis=ndim - 1))
            translation = {"y": float(iy * step), "x": float(ix * step)}
            if ndim == 3:
                translation["z"] = 0.0
            sims.append(tsi.get_sim_from_array(data, dims=sdims, translation=translation))
    return sims


EXACT_WRAPPERS = (
    "exact_affine_batch_2d", "exact_affine_batch_3d_sepy", "exact_affine_batch_3d_general",
)


class StageTimer:
    """Splits one fuse() call into plan, upload, kernel, blend and download
    by wrapping the stages that fusion._core calls (the copies are
    residency's); the kernel wrappers stay
    untouched, so their launch counts stay true. A stage that runs several
    times in the call (the exact-affine tier's launches and blends) sums."""

    def __init__(self, torch, tcore, tf, tea):
        self.torch, self.tcore, self.tf, self.tea = torch, tcore, tf, tea
        self.events = {}
        self.t_upload_start = None
        self.kernel_call = None
        self.weights_call = None
        self.fullest = -1

    def _timed(self, name, fn, before=None):
        torch = self.torch

        def wrapped(*a, **k):
            if before:
                before(a, k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            self.events.setdefault(name, []).append((e0, e1))
            return out

        return wrapped

    def __enter__(self):
        from multiview_stitcher_torch import residency

        tcore, tf, tea = self.tcore, self.tf, self.tea
        self._saved = (residency.tiles_to_device, residency.download, tcore.translation_fusion,
                       tcore._blend_batch)
        self._saved_exact = {n: getattr(tea, n) for n in EXACT_WRAPPERS}

        def mark(a, k):
            self.t_upload_start = time.perf_counter()

        def keep(a, k):
            self.kernel_call = (a, k)

        def keep_fullest_data_launch(a, k):
            # data resamples have cval NaN, weight resamples cval 0
            n = int(k["valid"].sum())
            if k["cval"] != k["cval"] and n > self.fullest:
                self.fullest, self.kernel_call, self.weights_call = n, (a, k), None
            elif k["cval"] == 0 and self.kernel_call is not None and self.weights_call is None:
                self.weights_call = (a, k)  # the weights launch that follows it

        residency.tiles_to_device = self._timed("upload", residency.tiles_to_device, mark)
        residency.download = self._timed("download", residency.download)
        tcore._blend_batch = self._timed("blend", tcore._blend_batch)
        tcore.translation_fusion = types.SimpleNamespace(
            TILE_SHAPE_2D=tf.TILE_SHAPE_2D,
            TILE_SHAPE_3D=tf.TILE_SHAPE_3D,
            _cast=tf._cast,
            fuse_translation_2d=self._timed("kernel", tf.fuse_translation_2d, keep),
            fuse_translation_3d=self._timed("kernel", tf.fuse_translation_3d, keep),
        )
        for n, fn in self._saved_exact.items():
            setattr(tea, n, self._timed("kernel", fn, keep_fullest_data_launch))
        return self

    def __exit__(self, *exc):
        from multiview_stitcher_torch import residency

        tcore = self.tcore
        (residency.tiles_to_device, residency.download, tcore.translation_fusion,
         tcore._blend_batch) = self._saved
        for n, fn in self._saved_exact.items():
            setattr(self.tea, n, fn)
        return False

    def split_ms(self, t_start, t_end):
        """Stage times of the call in ms; ``other_ms`` is what the named
        stages leave of the wall time (host work between launches)."""
        self.torch.cuda.synchronize()
        out = {"plan_ms": (self.t_upload_start - t_start) * 1e3}
        for name in ("upload", "kernel", "blend", "download"):
            if name in self.events:
                out[f"{name}_ms"] = sum(e0.elapsed_time(e1) for e0, e1 in self.events[name])
        out["other_ms"] = (t_end - t_start) * 1e3 - sum(out.values())
        return out


def covered_voxel_views(np, offs, extents, scale_arr, out_shape):
    """(output voxel, view) pairs where a view is valid: this run's work."""
    scale_arr = np.broadcast_to(np.asarray(scale_arr, np.float64), offs.shape)
    total = 0
    for v in range(len(offs)):
        n = 1
        for d, O in enumerate(out_shape):
            o = np.arange(O, dtype=np.float64)
            c = scale_arr[v, d] * o + offs[v, d]
            n *= int(np.count_nonzero((c >= 0) & (c <= extents[v, d] - 1)))
        total += n
    return total


def time_kernel_ms(torch, fn, args, kw, reps, flush=None):
    """Mean time of ``fn(*args, **kw)`` over ``reps`` calls, by CUDA events:
    around the whole run of calls, or with ``flush`` (a buffer larger than
    the L2 cache, zeroed before each call) around each call on a cold L2."""
    fn(*args, **kw)  # warm
    torch.cuda.synchronize()
    if flush is None:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def main_path(np, torch, tsi, tcore, tf, tea, tstream, fuse, ndim, n, tile, overlap, band_tiles):
    """Phases 4 and 6: one main path through fuse(), checked and timed. Its
    537 MB of tiles stream through banded kernel calls (fusion._streaming),
    as in the reference; the monolithic tier runs on the same tiles in the
    same run (STREAM_BYTES raised for that call) for its stage split and the
    kernel's own timings, and the two outputs are compared. Returns the
    results, the sims, the monolithic output and the streamed one."""
    label = f"{ndim}d main path"
    sims = grid_sims(np, tsi, ndim, n, tile, overlap, seed=ndim)
    step = tile - overlap
    expect = ((tile,) if ndim == 3 else ()) + ((n - 1) * step + tile,) * 2
    wrapper = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
    plain = tf.fuse_translation_3d_plain if ndim == 3 else tf.fuse_translation_2d_plain

    t0 = time.perf_counter()
    cold = fuse(sims, transform_key=KEY)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del cold

    # the main path's run: counts set to 0 just before, read just after. The
    # arguments of the middle band's launch, as the wrapper checked them, are
    # kept to check and time the kernel at the shapes the streamed path gives
    # it (the wrappers count their launches through their own module names,
    # so the launch is watched, not them; nothing here waits for the card)
    middle = tstream.last_telemetry["bands_total"] // 2
    tf.fuse_translation_2d.launches = 0
    tf.fuse_translation_3d.launches = 0
    launch = tf._launch
    seen = []

    def keep_middle_band(*a, **k):
        if len(seen) == middle:
            band[:] = [a, k]
        seen.append(1)
        return launch(*a, **k)

    band = []
    tf._launch = keep_middle_band
    # the cold call seeded the device tile cache: it is emptied, so that
    # this call reads and uploads its tiles as a first call does
    tcore.clear_device_tile_cache()
    try:
        t0 = time.perf_counter()
        fused = fuse(sims, transform_key=KEY)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        tf._launch = launch
    stream = dict(tstream.last_telemetry)
    launches = wrapper.launches
    other = tf.fuse_translation_2d if ndim == 3 else tf.fuse_translation_3d
    if (launches < 3 or launches != stream["bands_total"] or stream["bands_done"] != launches
            or other.launches):
        raise AssertionError(f"{label}: kernel launches {launches}, other kernel {other.launches}, "
                             f"streaming {stream}")

    # the monolithic tier on the same tiles, split into its stages (the
    # cache emptied again, so that the split has its upload)
    saved = tcore.STREAM_BYTES
    tcore.STREAM_BYTES = 1 << 62
    tcore.clear_device_tile_cache()
    try:
        with StageTimer(torch, tcore, tf, tea) as st:
            t0 = time.perf_counter()
            mono = fuse(sims, transform_key=KEY).data
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mono_s = t1 - t0
            split = st.split_ms(t0, t1)
    finally:
        tcore.STREAM_BYTES = saved
    out = fused.data
    diff = np.abs(out.astype(np.int32) - mono.astype(np.int32))
    stream_err, stream_diff = int(diff.max()), int(np.count_nonzero(diff))
    del diff
    if stream_err > UINT_COUNTS:
        raise AssertionError(
            f"{label}: streamed output differs from the monolithic one by {stream_err}")

    # the streamed path again, with the stack the monolithic call left in
    # the device tile cache: every batch a gather on the card
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    t0 = time.perf_counter()
    again = fuse(sims, transform_key=KEY).data
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    resident = dict(tstream.last_telemetry)
    resident_launches = wrapper.launches
    if (not np.array_equal(again, fused.data) or resident["up_bytes"]
            or resident["up_batches_resident"] != resident["batches"]
            or resident_launches != resident["bands_total"] or other.launches):
        raise AssertionError(f"{label}: the resident repeat launched {resident_launches}, "
                             f"streaming {resident}, equal {np.array_equal(again, fused.data)}")
    del again

    if out.shape != expect or out.dtype != np.uint16:
        raise AssertionError(f"{label}: output {out.shape} {out.dtype}, expected {expect} uint16")
    # a window in the middle of tile (5, 5), away from every overlap and
    # border taper, holds that view alone at full weight: the output equals
    # the tile there, exactly
    c = tile // 2 - 8
    y0 = 5 * step + c
    win = (slice(y0, y0 + 16), slice(y0, y0 + 16))
    twin = (slice(c, c + 16), slice(c, c + 16))
    if ndim == 3:
        win, twin = (slice(16, 48),) + win, (slice(16, 48),) + twin
    if not np.array_equal(out[win], sims[5 * n + 5].data[twin]):
        raise AssertionError(f"{label}: interior of tile (5, 5) is not the tile")
    log(f"{label}: output {out.shape} {out.dtype}, cold fuse {cold_s:.3f} s, "
        f"warm fuse {warm_s:.3f} s (streamed, the device tile cache emptied first), "
        f"launches {launches}")
    log(f"{label}: streaming " + json.dumps({
        k: (round(v, 3) if isinstance(v, float) else v) for k, v in stream.items()
    }) + f"; {stream_diff} voxels differ from the monolithic output (max {stream_err})")
    log(f"{label}: monolithic warm fuse {mono_s:.3f} s (the device tile cache emptied first), "
        "split " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    log(f"{label}: resident repeat (streamed, every batch gathered from the stack the "
        f"monolithic call cached) {resident_s:.3f} s, up {resident['up_bytes']} bytes, "
        f"{resident['up_batches_resident']} of {resident['batches']} batches resident, stream "
        f"spans ms up {resident['up_ms']} compute {resident['compute_ms']} down "
        f"{resident['down_ms']}, launches {resident_launches}, bit-equal to the warm call True")

    # the kernel at the main-path shapes: the launch alone, on arguments
    # checked and packed once, warm and on a cold L2; beside it the wrapper's
    # own call with its tables already on the card (it checks and packs them
    # anew, some ten small torch ops a call)
    args, kw = st.kernel_call
    tiles = args[0]
    dev_args = (tiles,) + tuple(torch.as_tensor(x).cuda() for x in args[1:])
    checked = tf._check_args(ndim, *dev_args, kw["out_shape"], kw["tile_shape"], kw["K"],
                             kw.get("origin"), kw["scale"], kw.get("scales"))
    launch_args = (ndim, tiles, kw["out_shape"], kw["tile_shape"], kw["K"], kw["out_dtype"],
                   checked)
    launch_kw = {"SZ": tf._z_stride(kw["scale"])} if ndim == 3 else {}
    kernel_ms = time_kernel_ms(torch, tf._launch, launch_args, launch_kw, reps=10)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=tiles.device)
    cold_l2_ms = time_kernel_ms(torch, tf._launch, launch_args, launch_kw, reps=5, flush=flush)
    del flush
    wrapper_ms = time_kernel_ms(torch, wrapper, dev_args, kw, reps=10)

    # the whole output against the plain version on the card, band by band
    view_idx = np.asarray(args[1])
    T0 = kw["tile_shape"][0]
    n_bands = -(-view_idx.shape[0] // band_tiles)
    err, plain_ms = 0.0, 0.0
    for b in range(n_bands):
        origin = np.zeros(ndim, np.int32)
        origin[0] = b * band_tiles * T0
        shape = (min(band_tiles * T0, expect[0] - origin[0]),) + tuple(expect[1:])
        bkw = dict(kw, out_shape=shape, origin=origin)
        bargs = (tiles, dev_args[1][b * band_tiles:(b + 1) * band_tiles]) + dev_args[2:]
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = plain(*bargs, **bkw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms += e0.elapsed_time(e1)
        ref = ref.cpu().numpy()
        got = out[origin[0]:origin[0] + shape[0]]
        err = max(err, max_err(got, ref, np))
        if not within_tol(got.astype(np.int64), ref.astype(np.int64), np):
            raise AssertionError(f"{label}: band {b} differs from the plain version by {err}")
        del ref
    log(f"{label}: kernel {kernel_ms:.3f} ms warm, {cold_l2_ms:.3f} ms on a cold L2, wrapper call "
        f"{wrapper_ms:.3f} ms, view lists {tuple(view_idx.shape)} at tile {tuple(kw['tile_shape'])}, "
        f"plain {plain_ms:.1f} ms over {n_bands} bands, max_abs_err vs plain {err:g} counts")

    t_bytes, t_ops, nbytes, pairs = translation_bound(
        np, ndim, tiles, args[1:], np.asarray(args[2]), np.asarray(args[3]),
        np.asarray(kw["scale"], np.float64) if kw.get("scales") is None else kw["scales"], expect,
    )

    # the middle band of the streamed run: its launch against the plain
    # version on the same checked arguments, and timed
    bargs, bkw = band
    got, _ = launch(*bargs, **bkw)
    ref = tf._plain(*bargs, **bkw)
    torch.cuda.synchronize()
    band_err = max_err(got.cpu().numpy(), ref.cpu().numpy(), np)
    if band_err > UINT_COUNTS:
        raise AssertionError(
            f"{label}: the middle band differs from the plain version by {band_err}")
    del got, ref
    band_ms = time_kernel_ms(torch, launch, bargs, bkw, reps=20)
    btiles, bshape, bchecked = bargs[1], bargs[2], bargs[6]
    bp = bchecked.params.cpu().numpy()
    # a band's voxel o is the output's o + origin (unit scale)
    b_bytes, b_ops, _, _ = translation_bound(
        np, ndim, btiles, (bchecked.view_idx, bchecked.params, bchecked.wgrids),
        bp[:, :ndim] + np.asarray(bchecked.origin, np.float32), bp[:, ndim:2 * ndim],
        bp[:, 4 * ndim:], bshape,
    )
    log(f"{label}: middle band {tuple(btiles.shape)} -> {tuple(bshape)} at origin "
        f"{list(bchecked.origin)}, kernel {band_ms:.4f} ms (bound {max(b_bytes, b_ops):.4f} ms), "
        f"max_abs_err vs plain {band_err:g} counts")
    err = max(err, band_err)
    return {
        "launches": int(launches),
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "cold_l2_ms": cold_l2_ms,
        "wrapper_ms": wrapper_ms,
        "cold_fuse_s": cold_s,
        "warm_fuse_s": warm_s,
        "resident_fuse_s": resident_s,
        "resident_launches": int(resident_launches),
        "resident_stream": resident,
        "stream": stream,
        "stream_vs_mono_max_counts": stream_err,
        "stream_vs_mono_voxels": stream_diff,
        "mono_warm_fuse_s": mono_s,
        **split,
        "bytes": nbytes,
        "voxel_views": pairs,
        "band_kernel_ms": band_ms,
        "band_bound_ms": max(b_bytes, b_ops),
        "band_max_abs_err": band_err,
    }, sims, mono, out


def translation_bound(np, ndim, tiles, tables, offs, extents, scale_arr, out_shape):
    """(byte time, operation time, bytes, covered voxel-view pairs) of one
    translation-kernel call: the tiles and ``tables`` read once, the uint16
    output written once; the operations of each covered (voxel, view) pair."""
    pairs = covered_voxel_views(np, offs, extents, scale_arr, out_shape)
    nbytes = (
        tiles.numel() * tiles.element_size() + int(np.prod(out_shape)) * 2
        + sum(int(t.numel() * t.element_size()) if hasattr(t, "numel")
              else int(np.asarray(t).nbytes) for t in tables)
    )
    ops = pairs * (OPS_PER_VOXEL_VIEW_3D if ndim == 3 else OPS_PER_VOXEL_VIEW_2D)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3, nbytes, pairs


def check_f1_fuse(np, torch, tsi, tf, tea, fuse):
    """Phase 3, faults F1 and F2: fuse() on the card keeps int16 and float64
    views in their dtype on both tiers (the kernels read and write them as
    float32), and boolean views boolean on the translation tier, against
    fuse(device="cpu"), which takes the plain versions. Inputs: a 2 x 2 grid
    of 40^2 tiles at offsets 0 and 30, values 0-999 (boolean: above 499),
    placed by translations or each turned a little about its centre."""
    worst = {}
    counters = {"translation": tf.fuse_translation_2d, "affine": tea.exact_affine_batch_2d}
    for tier, counter in counters.items():
        for dtype in (np.int16, np.float64) + ((np.bool_,) if tier == "translation" else ()):
            rng = np.random.default_rng(17)
            sims = []
            for iy in range(2):
                for ix in range(2):
                    data = rng.random((40, 40)) * 999
                    data = data > 499 if dtype == np.bool_ else data.astype(dtype)
                    sim = tsi.get_sim_from_array(data,
                                                 translation={"y": 30.0 * iy, "x": 30.0 * ix})
                    if tier == "affine":
                        lin = rot2(np, 0.05 * (2 * iy + ix - 1.5))
                        tsi.set_sim_affine(sim, about_centre(np, lin, [30.0 * iy + 19.5,
                                                                       30.0 * ix + 19.5]), KEY)
                    sims.append(sim)
            before = counter.launches
            got = fuse(sims, transform_key=KEY, output_chunksize=32).data
            torch.cuda.synchronize()
            launched = counter.launches - before
            ref = fuse(sims, transform_key=KEY, output_chunksize=32, device="cpu").data
            err = max_err(got, ref, np)
            if dtype == np.bool_:
                ok = err == 0
            elif dtype == np.int16:
                ok = err <= UINT_COUNTS
            elif tier == "translation":
                ok = within_tol(got, ref, np)
            else:  # the exact-affine bound on data in [0, 100), on data in [0, 999)
                ok = err <= EXACT_ATOL * 10
            ok = ok and got.dtype == ref.dtype == dtype and got.shape == ref.shape and launched > 0
            log(f"  F1 fuse {tier:11s} {np.dtype(dtype).name:7s}: output {got.shape} {got.dtype}, "
                f"{launched} launches, max_abs_err vs plain {err:.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"F1 fuse {tier} {np.dtype(dtype).name}: {got.dtype}, err {err}")
            worst[f"{tier}_{np.dtype(dtype).name}"] = err
    return worst


def zarr_north_star(np, torch, tsi, tf, tstream, fuse, sims, mono, work):
    """Phase 5: the north star zarr -> zarr at full size. Each tile of the 3D
    main path is written as its own zarr v2 array by the port's writer,
    opened lazily, and fused with ``output_chunksize=128`` into an OME-Zarr
    through the streaming tier, cold and warm (the warm run is the one whose
    launches count). Level 0, read back through the port's reader, is held
    against the monolithic output of the same tiles (itself held against the
    plain version in phase 4); the multiscales metadata and every pyramid
    level must exist, and level 1 must be the block mean of level 0. The
    files live under ``work``: the fused store (``fused.ome.zarr``) is kept
    for the ``zarr3:`` phase, and the tiles for it and the API phase,
    returned as lazy sims beside the results (all of ``work`` is removed
    when this phase fails)."""

    from multiview_stitcher_torch import msi_utils
    from multiview_stitcher_torch.fusion import _core as tcore
    from multiview_stitcher_torch.io import zarr_backend
    from multiview_stitcher_torch.ops import pyramid as tpyr

    label = "3d zarr->zarr"
    shutil.rmtree(work, ignore_errors=True)
    out_url = str(work / "fused.ome.zarr")
    finalize = tcore.ngff_utils.finalize_ome_zarr_levels
    pyramid_s = []

    def timed_finalize(*a, **k):
        t = time.perf_counter()
        finalize(*a, **k)
        pyramid_s.append(time.perf_counter() - t)

    try:
        # the disk's own rate: one 256 MiB file written from memory
        work.mkdir(parents=True)
        blob = np.ones(128 << 20, np.uint16)
        t0 = time.perf_counter()
        blob.tofile(work / "probe.bin")
        disk_mb_s = blob.nbytes / 1e6 / (time.perf_counter() - t0)
        (work / "probe.bin").unlink()
        del blob
        t0 = time.perf_counter()
        lazy = []
        for i, s in enumerate(sims):
            url = str(work / "tiles" / f"tile_{i:04d}.zarr")
            arr = zarr_backend.create_zarr_array(url, s.data.shape, s.data.shape, s.data.dtype)
            arr[...] = s.data
            lazy.append(tsi.get_sim_from_array(zarr_backend.open_zarr_array(url), dims=s.dims,
                                               translation=dict(s.origin)))
        write_s = time.perf_counter() - t0
        runs = {}
        tcore.ngff_utils = types.SimpleNamespace(
            finalize_ome_zarr_levels=timed_finalize,
            read_sim_from_ome_zarr=tcore.ngff_utils.read_sim_from_ome_zarr,
            _zarr_format=tcore.ngff_utils._zarr_format,
        )
        for run in ("cold", "warm"):
            # the warm run is this path's run: counts set to 0 just before,
            # and the device tile cache the cold run seeded emptied, so that
            # it reads its tiles
            tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
            tpyr.coarsen_mean.launches = 0
            tcore.clear_device_tile_cache()
            t0 = time.perf_counter()
            res = fuse(lazy, transform_key=KEY, output_chunksize=128, output_zarr_url=out_url)
            torch.cuda.synchronize()
            runs[run] = {"wall_s": time.perf_counter() - t0, "pyramid_s": pyramid_s[-1],
                         **tstream.last_telemetry}
        launches = tf.fuse_translation_3d.launches
        pyramid_launches = tpyr.coarsen_mean.launches
        tele = runs["warm"]
        if (launches < 3 or launches != tele["bands_total"] or tele["bands_done"] != launches
                or tf.fuse_translation_2d.launches):
            raise AssertionError(f"{label}: launches {launches}, streaming {tele}")

        level0 = np.asarray(zarr_backend.open_zarr_array(out_url + "/0"))
        if level0.shape != mono.shape or level0.dtype != mono.dtype or res.data.shape != mono.shape:
            raise AssertionError(f"{label}: level 0 {level0.shape} {level0.dtype}, expected "
                                 f"{mono.shape} {mono.dtype}")
        diff = np.abs(level0.astype(np.int32) - mono.astype(np.int32))
        err, n_diff = int(diff.max()), int(np.count_nonzero(diff))
        del diff
        if err > UINT_COUNTS:
            raise AssertionError(f"{label}: level 0 differs from the in-memory output by {err}")
        attrs, fmt = zarr_backend.read_group_metadata(out_url)
        datasets = attrs["multiscales"][0]["datasets"]
        shapes = msi_utils.calc_resolution_levels(dict(zip("zyx", level0.shape)))[0]
        levels = []
        for ds, shp in zip(datasets, shapes):
            arr = zarr_backend.open_zarr_array(f"{out_url}/{ds['path']}")
            levels.append(arr.shape)
            if arr.shape != tuple(shp.values()) or arr.dtype != level0.dtype:
                raise AssertionError(f"{label}: level {ds['path']} is {arr.shape} {arr.dtype}")
        if fmt != 2 or len(datasets) != len(shapes) or len(shapes) < 2:
            raise AssertionError(f"{label}: {len(datasets)} levels in the metadata, expected "
                                 f"{len(shapes)}")
        # one launch a block of every level after level 0 (512-wide blocks)
        want = sum(int(np.prod([-(-n // 512) for n in shp.values()])) for shp in shapes[1:])
        if pyramid_launches != want:
            raise AssertionError(f"{label}: {pyramid_launches} pyramid launches, expected {want}")
        level1 = np.asarray(zarr_backend.open_zarr_array(out_url + "/1"))
        if not np.array_equal(level1, msi_utils._coarsen_mean(level0, (1, 2, 2))):
            raise AssertionError(f"{label}: level 1 is not the block mean of level 0")
        disk = sum(f.stat().st_size for f in work.rglob("*") if f.is_file())
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    finally:
        tcore.ngff_utils = sys.modules["multiview_stitcher_torch.io.ngff_utils"]
    mvox = level0.size / 1e6
    for run, r in runs.items():
        log(f"{label} {run}: wall {r['wall_s'] * 1e3:.1f} ms, {mvox / r['wall_s']:.1f} Mvox/s out, "
            f"streaming {r['elapsed_s'] * 1e3:.1f} ms, pyramid and metadata "
            f"{r['pyramid_s'] * 1e3:.1f} ms, "
            f"bands {r['bands_total']} of {r['band_height']} rows on axis {r['band_axis']}, "
            f"NV {r['nv']}, batches {r['batches']} of {r['batch_views']} views, "
            f"up {r['up_bytes'] / 1e6:.1f} MB, down {r['down_bytes'] / 1e6:.1f} MB, "
            "stream spans ms "
            + " ".join(f"{k} {r[k + '_ms']}" for k in ("up", "compute", "down"))
            + " (each the summed span, first to last event, of its stage's work; the device "
            "tile cache emptied before the run)")
    log(f"{label}: tiles written in {write_s:.2f} s, a 256 MiB file at {disk_mb_s:.0f} MB/s, "
        f"levels {levels} ({pyramid_launches} pyramid launches), {disk / 1e6:.0f} MB on disk, "
        f"level 0 vs in-memory {n_diff} voxels differ (max {err} counts); {card_line()}")
    return {"launches": int(launches), "pyramid_launches": int(pyramid_launches),
            "max_abs_err": err, "voxels_differ": n_diff,
            "tiles_write_s": write_s, "disk_write_mb_s": disk_mb_s,
            "levels": [list(x) for x in levels], "disk_bytes": disk,
            "out_mvox": mvox, **{run: r for run, r in runs.items()}}, lazy


def pyramid_phase(np, torch):
    """Phase 3b, the pyramid's block means (``ops.pyramid.coarsen_mean``):
    each small case of ``PYRAMID_SMALL`` in uint8 and uint16, and the
    largest factor product of each dtype on all-max data, against the plain
    version on the card and ``msi_utils._coarsen_mean`` on the host, bit for
    bit; then each block of ``PYRAMID_BLOCKS`` (uint16, random counts),
    checked the same way and timed by CUDA events beside its byte bound
    (input read once, output written once) and the plain version; the first
    block also on a cold L2 and with its pageable host copies each way, as
    ``io.ngff_utils._build_levels`` makes them."""
    from multiview_stitcher_torch import msi_utils
    from multiview_stitcher_torch.ops import pyramid as tpyr

    rng = np.random.default_rng(22)
    dev = torch.device("cuda")
    worst = [0]

    def check(host, factors, label):
        x = torch.from_numpy(host).to(dev)
        got = tpyr.coarsen_mean(x, factors)
        torch.cuda.synchronize()
        plain = tpyr.coarsen_mean_plain(x, factors)
        ref = msi_utils._coarsen_mean(host, factors)
        err = max(max_err(got.cpu().numpy(), plain.cpu().numpy(), np),
                  max_err(got.cpu().numpy(), ref, np))
        if err or got.dtype != x.dtype or tuple(got.shape) != ref.shape:
            raise AssertionError(f"pyramid: {label} differs from the plain version by {err}")
        worst[0] = max(worst[0], err)
        return x

    launches0 = tpyr.coarsen_mean.launches
    n_small = 0
    for dtype in (np.uint8, np.uint16):
        top = np.iinfo(dtype).max
        for shape, factors in PYRAMID_SMALL:
            check(rng.integers(0, top, shape, dtype=dtype, endpoint=True), factors,
                  f"{np.dtype(dtype).name} {shape} at {factors}")
            n_small += 1
        shape, factors = (((2, 3, 2 * 65537 + 5), (1, 1, 65537)) if dtype == np.uint16
                          else ((1, 257, 65537 + 3), (1, 257, 65537)))
        check(np.full(shape, top, dtype), factors, f"all-max {np.dtype(dtype).name} at {factors}")
        n_small += 1
    log(f"pyramid: {n_small} small cases bit-equal to the plain version and to "
        f"msi_utils._coarsen_mean; {card_line()}")

    blocks = []
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for i, shape in enumerate(PYRAMID_BLOCKS):
        host = rng.integers(0, 4000, shape, dtype=np.uint16)
        x = check(host, (1, 2, 2), f"block {shape}")
        out_bytes = 2 * (shape[0] * (shape[1] // 2) * (shape[2] // 2))
        bound_ms = (x.nbytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        r = {"shape": list(shape), "bound_ms": bound_ms,
             "ms": time_kernel_ms(torch, tpyr.coarsen_mean, (x, (1, 2, 2)), {}, 50),
             "plain_ms": time_kernel_ms(torch, tpyr.coarsen_mean_plain, (x, (1, 2, 2)), {}, 3)}
        r["share"] = r["bound_ms"] / r["ms"]
        if i == 0:
            r["cold_ms"] = time_kernel_ms(torch, tpyr.coarsen_mean, (x, (1, 2, 2)), {}, 20,
                                          flush=flush)
            out = tpyr.coarsen_mean(x, (1, 2, 2))
            r["h2d_ms"] = best_s(lambda: (torch.from_numpy(host).to(dev),
                                          torch.cuda.synchronize()), reps=3)[0] * 1e3
            r["d2h_ms"] = best_s(lambda: out.cpu().numpy(), reps=3)[0] * 1e3
        log(f"pyramid: block {shape} uint16 at (1, 2, 2): kernel {r['ms']:.4f} ms"
            + (f" (cold L2 {r['cold_ms']:.4f} ms)" if "cold_ms" in r else "")
            + f", bound {bound_ms:.4f} ms (bytes), {100 * r['share']:.1f} % of it; plain "
            f"{r['plain_ms']:.3f} ms"
            + (f"; host copies {r['h2d_ms']:.1f} ms up, {r['d2h_ms']:.1f} ms down (pageable)"
               if "h2d_ms" in r else ""))
        blocks.append(r)
        del x, host
    del flush
    torch.cuda.empty_cache()
    job_ms = sum(b["ms"] for b in blocks)
    log(f"pyramid: the zarr job's six blocks {job_ms:.4f} ms of kernel, bound "
        f"{sum(b['bound_ms'] for b in blocks):.4f} ms; {tpyr.coarsen_mean.launches - launches0} "
        f"launches in these checks and timings; {card_line()}")
    main = blocks[0]
    return {"bench_launches": tpyr.coarsen_mean.launches - launches0, "max_abs_err": worst[0],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "job_ms": job_ms, "blocks": blocks}


def scoring_items(np, torch, tcs, im0, im1, t, keep):
    """Each kept (pair, candidate) item's scoring box (lo, hi) and whether it
    keeps a tenth of the moving crop, by the plain version's own helpers, in
    groups of 64 items: what the candidate kernel's work follows."""
    im0nm, ui, vp1, lo0, hi0, f1, m1 = tcs._pair_terms(im0, im1, None)
    pi, ci = torch.nonzero(keep, as_tuple=True)
    los, his, oks = [], [], []
    for g in range(0, len(pi), 64):
        p, c = pi[g:g + 64], ci[g:g + 64]
        im1t = tcs._translate(f1[p], m1[p], t[p, c])
        _, ok, lo, hi, _ = tcs._candidate_stats(im1t, im0nm[p], vp1[p], ui[p], lo0[p], hi0[p])
        los.append(lo.cpu().numpy())
        his.append(hi.cpu().numpy())
        oks.append(ok.cpu().numpy())
    return np.concatenate(los), np.concatenate(his), np.concatenate(oks)


def scoring_ops(np, shape, lo, hi, frac_ok):
    """The candidate kernel's f32 operations over items with boxes ``lo``,
    ``hi`` (N, ndim) and ``frac_ok`` (N,), following its loops: every item
    sweeps the crop once; an item that keeps a tenth of the moving crop and
    fits a window stages each interior tile's halos and takes its window
    passes (z in 3D, then y, then x) and each interior pixel's SSIM."""
    ndim = len(shape)
    n = int(np.prod(shape))
    shift = SCORE_SHIFT_OPS[ndim]
    tile = SCORE_TILE[ndim]
    ops = len(lo) * n * (shift + SCORE_SWEEP_OPS)

    def along(length, t, extra):
        """Sum over the tiles along an axis of (tile extent + extra)."""
        q, rem = divmod(length, t)
        return q * (t + extra) + (rem + extra if rem else 0)

    for lo_i, hi_i, ok in zip(lo, hi, frac_ok):
        m = int((hi_i - lo_i + 1).min())
        win_eff = min(m - (m - 1) % 2, 7)
        if not ok or win_eff < 3:
            continue
        win = 7 if win_eff >= 7 else 5 if win_eff >= 5 else 3
        r = win // 2
        ext = [1] * (3 - ndim) + [int(h - l + 1 - 2 * r) for l, h in zip(lo_i, hi_i)]
        rz = r if ndim == 3 else 0
        z, z0 = along(ext[0], tile[0], 2 * rz), along(ext[0], tile[0], 0)
        y, y0 = along(ext[1], tile[1], 2 * r), along(ext[1], tile[1], 0)
        x, x0 = along(ext[2], tile[2], 2 * r), along(ext[2], tile[2], 0)
        ops += z * y * x * (shift + SCORE_STAGE_OPS)
        if ndim == 3:
            ops += z0 * y * x * (8 * win + 5) + z0 * y0 * x * (5 * win + 5)
        else:
            ops += y0 * x * (8 * win + 5)
        ops += ext[0] * ext[1] * ext[2] * (5 * win + 5 + SCORE_SSIM_OPS)
    return ops


def scoring_phase(np, torch, buckets=SCORING_BUCKETS):
    """Phase 3c, the candidate scoring of the pairwise registration
    (``ops.candidate_scoring``) at each bucket of ``SCORING_BUCKETS``: crops
    of a smooth field, the moving one off by a fraction of a pixel, both
    with NaN border rows as the overlap resample leaves them, rescaled as the
    registration core rescales them; three proposals (the true shift, its
    rounding and a pixel off) expanded into their sign and wrap candidates
    (48 a pair in 2D, 192 in 3D) by the core's own expansion. The kernel's
    scores against the plain version on the card (within 1e-5, -1 and -inf
    exactly), the winners' shifted crops, masks and statistics bit for bit;
    both launches timed by CUDA events beside the larger of their byte bound
    (crops, shifts and flags read once, the outputs written once) and their
    operation bound (``scoring_ops``, from each item's own box and window)
    and the plain versions."""
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch.ops import candidate_scoring as tcs
    from multiview_stitcher_torch.ops import phase_correlation as pc_ops
    from scipy import ndimage

    rng = np.random.default_rng(27)
    dev = torch.device("cuda")
    launches0 = tcs.score_candidates.launches
    out = {}
    for label, B, shape in buckets:
        ndim = len(shape)
        ims0, ims1, proposals = [], [], []
        for _ in range(B):
            field = ndimage.gaussian_filter(rng.random(tuple(s + 16 for s in shape)), 1.5)
            true = rng.uniform(-3, 3, ndim)
            inner = tuple(slice(8, 8 + s) for s in shape)
            ims0.append(field[inner])
            ims1.append(ndimage.shift(field, -true, order=1, mode="nearest")[inner])
            proposals.append([true, np.round(true), true + 1.0])
        im0 = np.stack(ims0).astype(np.float32)
        im1 = np.stack(ims1).astype(np.float32)
        im0[:, :1] = np.nan
        im1[:, -2:] = np.nan
        im0 = pc_ops.rescale_intensity(torch.from_numpy(im0).to(dev), ndim)
        im1 = pc_ops.rescale_intensity(torch.from_numpy(im1).to(dev), ndim)
        props = torch.tensor(np.asarray(proposals), dtype=torch.float32, device=dev)
        t, keep = treg._expand_candidates(props, torch.ones(props.shape[:2], dtype=torch.bool,
                                                             device=dev), shape)
        got = tcs.score_candidates(im0, im1, t, keep)
        torch.cuda.synchronize()
        ref = tcs.score_candidates_plain(im0, im1, t, keep)
        g, r = got.cpu().numpy(), ref.cpu().numpy()
        special = ~np.isfinite(r) | (r == -1.0)
        err = float(np.abs(g[~special] - r[~special]).max(initial=0.0))
        if not np.array_equal(g[special], r[special]) or err > 1e-5:
            raise AssertionError(f"scoring: {label} scores differ from the plain version by {err}")
        best = got.argmax(-1)
        t_best = t[torch.arange(B, device=dev), best].contiguous()
        won = tcs.shift_winners(im0, im1, t_best)
        plain_won = tcs.shift_winners_plain(im0, im1, t_best)
        img, pimg = won[0], plain_won[0]
        if not (torch.equal(torch.isnan(img), torch.isnan(pimg))
                and torch.equal(torch.nan_to_num(img).view(torch.int32),
                                torch.nan_to_num(pimg).view(torch.int32))
                and all(torch.equal(a, b) for a, b in zip(won[1:], plain_won[1:]))):
            raise AssertionError(f"scoring: {label} winners differ from the plain version")
        n_px = B * int(np.prod(shape))
        crops = 2 * 4 * n_px
        lo, hi, ok = scoring_items(np, torch, tcs, im0, im1, t, keep)
        ops = scoring_ops(np, shape, lo, hi, ok)
        w_lo, w_hi, _ = scoring_items(np, torch, tcs, im0, im1, t_best[:, None],
                                      torch.ones((B, 1), dtype=torch.bool, device=dev))
        w_box = int(np.clip(w_hi - w_lo + 1, 0, None).prod(-1).sum())
        w_ops = (n_px * (SCORE_SHIFT_OPS[ndim] + SCORE_SWEEP_OPS)
                 + w_box * (SCORE_SHIFT_OPS[ndim] + SCORE_BOX_OPS))
        t_bytes = (crops + t.nbytes + keep.nbytes + got.nbytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        w_bytes = (crops + t_best.nbytes + 5 * n_px + 5 * B) / HBM_BYTES_PER_S * 1e3
        w_ops_ms = w_ops / FP32_OPS_PER_S * 1e3
        r_ = {"pairs": B, "shape": list(shape), "candidates": int(t.shape[1]),
              "kept": int(keep.sum()), "scored": int(np.isfinite(g).sum()),
              "max_abs_err": err, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "winners_ops": w_ops, "winners_bound_ms": max(w_bytes, w_ops_ms),
              "winners_bound_by": "bytes" if w_bytes >= w_ops_ms else "operations",
              "ms": time_kernel_ms(torch, tcs.score_candidates, (im0, im1, t, keep), {}, 50),
              "winners_ms": time_kernel_ms(torch, tcs.shift_winners, (im0, im1, t_best), {}, 50),
              "plain_ms": time_kernel_ms(torch, tcs.score_candidates_plain, (im0, im1, t, keep),
                                         {}, 5),
              "winners_plain_ms": time_kernel_ms(torch, tcs.shift_winners_plain,
                                                 (im0, im1, t_best), {}, 5)}
        r_["share"] = r_["bound_ms"] / r_["ms"]
        log(f"scoring: {label} bucket of {B} pairs of {'x'.join(map(str, shape))}, "
            f"{r_['candidates']} candidates a pair ({r_['kept']} kept, {r_['scored']} scored): "
            f"kernel {r_['ms']:.4f} ms, bound {1e3 * r_['bound_ms']:.3f} us ({r_['bound_by']}: "
            f"{ops:.4g} operations, {1e3 * t_ops:.3f} us; bytes {1e3 * t_bytes:.3f} us), "
            f"{100 * r_['share']:.3f} % of it; plain {r_['plain_ms']:.3f} ms; winners kernel "
            f"{r_['winners_ms']:.4f} ms (bound {1e3 * r_['winners_bound_ms']:.3f} us, "
            f"{r_['winners_bound_by']}), plain "
            f"{r_['winners_plain_ms']:.3f} ms; scores within {err:.2e} of the plain version, "
            f"winners bit-equal; {card_line()}")
        out[label] = r_
    main = out[buckets[0][0]]
    return {"bench_launches": tcs.score_candidates.launches - launches0,
            "max_abs_err": max(v["max_abs_err"] for v in out.values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None, "buckets": out}


def best_s(fn, reps=2):
    """Least wall time of ``reps`` calls of ``fn`` (seconds) and its result."""
    best, res = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, res


def event_ms(torch, fn, reps=5):
    """Mean time of ``fn()`` on the card by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def same_u16(torch, a, b) -> bool:
    """Two uint16 tensors equal bit for bit (compared as int16)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))


def link_phase(np, torch, sims):
    """Phase 5b, the link codec (``ops.link_codec``, a library that neither
    fusion nor registration calls) on the 3D north star's tiles: (a) the
    host half's rates, native and numpy, on one 8 MB upload batch; (b) the
    torch half's times on the card on the same batch; (c) ``put_packed`` /
    ``fetch_packed`` of the whole 537 MB tile stack beside one pinned copy
    each way. Every round trip is held bit for bit."""
    from multiview_stitcher_torch.ops import link_codec as lc
    from multiview_stitcher_torch.utils import misc

    card = card_line()
    say = lambda msg: log(f"{card}: link: {msg}")  # noqa: E731
    device = misc.resolve_device(None)
    cuda = device.type == "cuda"
    res = {}
    t_phase = time.perf_counter()
    tiles = np.stack([s.data for s in sims])
    tile_mb = tiles.nbytes / 1e6
    per_batch = max(1, (8 << 20) // tiles[0].nbytes)
    batch = np.ascontiguousarray(tiles[:per_batch])
    mb = batch.nbytes / 1e6
    X, Y = batch.shape[-1], batch.shape[-2]
    flat = batch.reshape(-1)

    # (a) the host half: MB/s of uint16 input, native C loops and numpy
    rates = {}
    native_codecs = lc._native_codecs
    if native_codecs() is None:
        raise AssertionError("link: the native codec library did not build")
    for route in ("native", "numpy"):
        if route == "numpy":
            lc._native_codecs = lambda: None
        try:
            for nb in (10, 12):
                s, packed = best_s(lambda: lc.pack_np(flat, nb))
                rates[f"{route}_pack_{nb}"] = mb / s
                s, back = best_s(lambda: lc.unpack_np(packed, nb, flat.size))
                rates[f"{route}_unpack_{nb}"] = mb / s
                if not np.array_equal(back, flat):
                    raise AssertionError(f"link: {route} unpack at {nb} bits is not the batch")
            for mode, enc, dec, args in (
                ("delta", lc.delta_encode_np, lc.delta_decode_np, ()),
                ("delta2", lc.delta2_encode_np, lc.delta2_decode_np, (X,)),
                ("delta3", lc.delta3_encode_np, lc.delta3_decode_np, (X, Y)),
            ):
                if route == "native" and mode != "delta":
                    continue  # numpy only: the C loops are first-order
                s, (f, z) = best_s(lambda: enc(flat, *args))
                rates[f"{route}_{mode}_encode"] = mb / s
                s, back = best_s(lambda: dec(f, z, *args, flat.size))
                rates[f"{route}_{mode}_decode"] = mb / s
                if not np.array_equal(back, flat):
                    raise AssertionError(f"link: {route} {mode} decode is not the batch")
        finally:
            lc._native_codecs = native_codecs
    say(f"(a) host half on one {mb:.1f} MB batch {tuple(batch.shape)}, MB/s of uint16 in: "
        + json.dumps({k: round(v, 1) for k, v in rates.items()}))
    res["host_mb_s"] = rates

    # (b) the torch half on the card, same batch: the bytes of the host half
    info_b, rec_b = {}, {}
    dev_b = lc.put_packed(batch, info=info_b, keep_packed=rec_b, device=device)
    t_b = torch.from_numpy(batch.view(np.int16)).to(device).view(torch.uint16)
    if not same_u16(torch, dev_b, t_b):
        raise AssertionError("link: put_packed of the batch is not the batch")
    for nb in (10, 12):
        if not np.array_equal(lc.pack_torch(t_b, nb).cpu().numpy(), lc.pack_np(flat, nb)):
            raise AssertionError(f"link: pack_torch at {nb} bits differs from pack_np")
    packed12 = lc.pack_torch(t_b, 12)
    x32 = lc._i32(t_b.reshape(-1))
    f3, z3 = lc._encode(x32, info_b["mode"], X, Y) if info_b["mode"] != "plain" else (None, None)
    dev_ms = {
        "pack_12": event_ms(torch, lambda: lc.pack_torch(t_b, 12)),
        "unpack_12": event_ms(torch, lambda: lc.unpack_torch(packed12, 12, flat.size)),
        "probe_all": event_ms(torch, lambda: lc._delta_probe_all(t_b.reshape(-1), X, Y)),
        "reassemble": event_ms(torch, lambda: lc.reassemble_packed(rec_b)),
    }
    if f3 is not None:
        dev_ms[f"{info_b['mode']}_encode"] = event_ms(
            torch, lambda: lc._encode(x32, info_b["mode"], X, Y))
        dev_ms[f"{info_b['mode']}_decode"] = event_ms(
            torch, lambda: lc._decode(f3, z3, info_b["mode"], flat.size, X, Y))
    say(f"(b) torch half on the card, same batch, ms by CUDA events: "
        + json.dumps({k: round(v, 4) for k, v in dev_ms.items()})
        + f"; the batch ships {info_b}")
    res["batch_info"], res["device_ms"] = info_b, dev_ms
    del dev_b, packed12, x32, f3, z3, rec_b

    # (c) the whole tile stack each way, beside one pinned copy each way
    pinned = torch.empty(tiles.shape, dtype=torch.int16, pin_memory=cuda)
    pinned.numpy()[...] = tiles.view(np.int16)
    ref_dev = torch.empty(tiles.shape, dtype=torch.int16, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_dev.copy_(pinned, non_blocking=cuda)
    torch.cuda.synchronize()
    copy_up_s = time.perf_counter() - t0
    ref_dev = ref_dev.view(torch.uint16)
    info_up = {}
    t0 = time.perf_counter()
    got = lc.put_packed(tiles, info=info_up, device=device)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    put_ok = same_u16(torch, got, ref_dev)
    del got
    t0 = time.perf_counter()
    pinned.copy_(ref_dev.view(torch.int16), non_blocking=cuda)
    torch.cuda.synchronize()
    copy_down_s = time.perf_counter() - t0
    host = np.empty(tiles.shape, np.uint16)
    info_down = {}
    t0 = time.perf_counter()
    lc.fetch_packed(ref_dev, out=host, info=info_down)
    fetch_s = time.perf_counter() - t0
    fetch_ok = bool(np.array_equal(host, tiles))
    del ref_dev, pinned, host
    torch.cuda.empty_cache()
    say(f"(c) the {tile_mb:.1f} MB tile stack {tuple(tiles.shape)}: put_packed {put_s:.3f} s "
        f"({info_up}), pinned copy up {copy_up_s * 1e3:.2f} ms; fetch_packed {fetch_s:.3f} s "
        f"({info_down}), pinned copy down {copy_down_s * 1e3:.2f} ms; bit-equal up {put_ok}, "
        f"down {fetch_ok}")
    if not (put_ok and fetch_ok):
        raise AssertionError("link: put_packed or fetch_packed of the tile stack is not the stack")
    res["stack"] = {"mb": tile_mb, "put_s": put_s, "put": info_up, "copy_up_ms": copy_up_s * 1e3,
                    "fetch_s": fetch_s, "fetch": info_down, "copy_down_ms": copy_down_s * 1e3}
    del tiles
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {res['phase_s']:.1f} s")
    return res


def cache_phase(np, torch, tcore, tf, tea, tstream, fuse, sims, mono, streamed, lazy, work):
    """Phase 5c, reuse across fuse() calls (ROADMAP item 15) on the 3D north
    star, from an empty device tile cache: (a) a cold streamed call that
    keeps no batches (the cache's budget set to 0) beside one that keeps
    them and seeds the cache, with the peak device memory of each; (b) the
    warm repeat, every batch gathered from the resident stack; (c) the lazy
    zarr tiles into a zarr store twice, the repeat reading no tile; (d) a
    pass past its deadline and its retry from the upload-resume stash; (e)
    the monolithic tier cold and again, the repeat taking its plan and
    tables from the plan cache. The streamed outputs are held bit for bit to
    phase 4's streamed output, the monolithic ones to its monolithic output
    and the zarr repeat to its cold store; a failed seeding (its
    RuntimeWarning) fails the phase. Returns the results with the launches
    of kernel 1 over (b)-(e)."""
    import warnings

    from multiview_stitcher_torch import residency
    from multiview_stitcher_torch.io import zarr_backend
    from multiview_stitcher_torch.utils import misc

    card = card_line()
    say = lambda msg: log(f"{card}: cache: {msg}")  # noqa: E731
    t_phase = time.perf_counter()
    res = {}
    key = residency.device_tile_cache.key_for(sims, misc.resolve_device(None))
    stack_bytes = sum(s.data.nbytes for s in sims)
    reads = []
    materialize = residency.materialize_tiles

    def counting(*a, **k):
        reads.append(1)
        return materialize(*a, **k)

    def streamed_call(label, data, want, **kw):
        tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
        n_reads = len(reads)
        t0 = time.perf_counter()
        out = fuse(data, transform_key=KEY, **kw).data
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tele = dict(tstream.last_telemetry)
        r = {"wall_s": wall, "launches": tf.fuse_translation_3d.launches,
             "tile_reads": len(reads) - n_reads, **tele}
        if want is not None:
            r["bit_equal"] = bool(np.array_equal(out, want))
            if not r["bit_equal"]:
                raise AssertionError(f"cache: {label} differs from phase 4's output")
        if (r["launches"] != tele["bands_total"] or tele["bands_done"] != tele["bands_total"]
                or tf.fuse_translation_2d.launches):
            raise AssertionError(f"cache: {label} launched {r['launches']} for "
                                 f"{tele['bands_total']} bands")
        return r

    def spans(r):
        return (f"stream spans ms up {r['up_ms']} compute {r['compute_ms']} down "
                f"{r['down_ms']}, fuse_translation_3d launches {r['launches']}")

    saved_budget, saved_stream = residency.TILE_CACHE_BYTES, tcore.STREAM_BYTES
    residency.materialize_tiles = counting
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="device tile cache seeding failed",
                                    category=RuntimeWarning)
            # (a) cold, without and with retention
            peaks = {}
            for run, budget in (("no_retention", 0), ("cold", saved_budget)):
                tcore.clear_device_tile_cache()
                torch.cuda.empty_cache()
                residency.TILE_CACHE_BYTES = budget
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                res[run] = streamed_call(f"(a) {run}", sims, streamed)
                peaks[run] = torch.cuda.max_memory_allocated() - base
                res[run]["peak_bytes"] = peaks[run]
            residency.TILE_CACHE_BYTES = saved_budget
            seeded = residency.device_tile_cache.get(key)
            if seeded is None:
                raise AssertionError("cache: the cold call seeded no stack")
            seeded_bytes = seeded.numel() * seeded.element_size()
            if seeded_bytes != stack_bytes or not res["cold"]["up_bytes"]:
                raise AssertionError(f"cache: seeded {seeded_bytes} bytes of {stack_bytes}")
            del seeded
            say(f"(a) cold streamed call from an empty cache: wall {res['cold']['wall_s']:.3f} "
                f"s, {res['cold']['tile_reads']} batch reads, up "
                f"{res['cold']['up_bytes'] / 1e6:.1f} MB, seeded entry {seeded_bytes / 1e6:.1f} MB; "
                f"peak device memory above the phase's base {peaks['cold'] / 1e6:.1f} MB keeping "
                f"the batches, {peaks['no_retention'] / 1e6:.1f} MB with the cache's budget at 0 "
                f"(wall {res['no_retention']['wall_s']:.3f} s); both bit-equal to phase 4")

            # (b) the warm repeat from the resident stack
            r = res["resident"] = streamed_call("(b) resident repeat", sims, streamed)
            if (r["up_bytes"] or r["tile_reads"] or r["up_batches_resident"] != r["batches"]):
                raise AssertionError(f"cache: the resident repeat {r}")
            say(f"(b) warm repeat from the resident stack: wall {r['wall_s']:.3f} s, up "
                f"{r['up_bytes']} bytes, {r['up_batches_resident']} of {r['batches']} batches "
                f"resident, {r['tile_reads']} tile reads, {spans(r)}, bit-equal to phase 4 "
                f"{r['bit_equal']}")

            # (c) the lazy tiles into a zarr store, twice
            url = str(work / "cache.ome.zarr")
            levels = {}
            for run in ("zarr_cold", "zarr_repeat"):
                res[run] = streamed_call(f"(c) {run}", lazy, None, output_chunksize=128,
                                         output_zarr_url=url)
                levels[run] = np.asarray(zarr_backend.open_zarr_array(url + "/0"))
            r = res["zarr_repeat"]
            r["bit_equal"] = bool(np.array_equal(levels["zarr_repeat"], levels["zarr_cold"]))
            vs_streamed = int(np.count_nonzero(levels["zarr_cold"] != streamed))
            if (not r["bit_equal"] or r["tile_reads"] or r["up_bytes"]
                    or not res["zarr_cold"]["tile_reads"]):
                raise AssertionError(f"cache: the zarr repeat read {r['tile_reads']} batches, "
                                     f"level 0 equal {r['bit_equal']}")
            del levels
            say(f"(c) zarr->zarr: cold {res['zarr_cold']['wall_s']:.3f} s with "
                f"{res['zarr_cold']['tile_reads']} batch reads, repeat {r['wall_s']:.3f} s with "
                f"{r['tile_reads']} tile reads and {r['up_bytes']} bytes up, {spans(r)}; level 0 "
                f"of the repeat bit-equal to the cold one {r['bit_equal']}, {vs_streamed} voxels "
                "differ from phase 4's streamed output")

            # (d) a pass past its deadline, then its retry. The deadline
            # counts the pass's set-up too, so it grows until a pass stops
            # with some uploads done
            for frac in (0.3, 0.45, 0.6, 0.75, 0.9):
                tcore.clear_device_tile_cache()
                tstream.STREAM_DEADLINE_S = frac * res["cold"]["elapsed_s"]
                try:
                    fuse(sims, transform_key=KEY)
                except tstream.StreamingDeadlineError as e:
                    partial = dict(e.telemetry)
                else:
                    raise AssertionError("cache: the pass did not stop at its deadline")
                finally:
                    tstream.STREAM_DEADLINE_S = None
                torch.cuda.synchronize()
                entry = dict(tstream._upload_stash)
                if entry:
                    break
            else:
                raise AssertionError("cache: no aborted pass left an upload-resume stash")
            n_stashed = len(entry["batches"])
            stash_bytes = sum(d.numel() * d.element_size() for d, _ in entry["batches"].values())
            del entry
            r = res["retry"] = streamed_call("(d) retry", sims, streamed)
            if (r["up_batches_reused"] != n_stashed or r["up_bytes"] >= res["cold"]["up_bytes"]
                    or tstream._upload_stash or residency.device_tile_cache.get(key) is None):
                raise AssertionError(f"cache: the retry reused {r['up_batches_reused']} of "
                                     f"{n_stashed} stashed batches, stash left "
                                     f"{bool(tstream._upload_stash)}")
            res["aborted"] = {k: partial[k] for k in ("bands_done", "bands_total", "up_bytes",
                                                      "elapsed_s", "deadline_s")}
            res["aborted"].update(stashed_batches=n_stashed, stash_bytes=stash_bytes)
            say(f"(d) a pass stopped at its {partial['deadline_s']:.3f} s deadline after "
                f"{partial['bands_done']} of {partial['bands_total']} bands stashed "
                f"{n_stashed} of {r['batches']} batches, {stash_bytes / 1e6:.1f} MB on the card; "
                f"the retry reused them, up {r['up_bytes'] / 1e6:.1f} MB against "
                f"{res['cold']['up_bytes'] / 1e6:.1f} MB cold, wall {r['wall_s']:.3f} s, seeded "
                f"the cache and retired the stash, bit-equal to phase 4 {r['bit_equal']}")

            # (e) the monolithic tier, cold and again
            tcore.STREAM_BYTES = 1 << 62
            tcore.clear_device_tile_cache()
            for run in ("mono_cold", "mono_repeat"):
                tf.fuse_translation_3d.launches = 0
                with StageTimer(torch, tcore, tf, tea) as st:
                    t0 = time.perf_counter()
                    out = fuse(sims, transform_key=KEY).data
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    split = st.split_ms(t0, t1)
                same = bool(np.array_equal(out, mono))
                res[run] = {"wall_s": t1 - t0, "launches": tf.fuse_translation_3d.launches,
                            "bit_equal": same, **split}
                if not same or res[run]["launches"] < 1:
                    raise AssertionError(f"cache: {run} differs from phase 4's monolithic output")
            del out
            cold, rep = res["mono_cold"], res["mono_repeat"]
            say(f"(e) monolithic: plan {cold['plan_ms']:.3f} ms cold (caches emptied), "
                f"{rep['plan_ms']:.3f} ms repeat; wall {cold['wall_s']:.3f} / "
                f"{rep['wall_s']:.3f} s, split of the repeat "
                + json.dumps({k: round(v, 3) for k, v in rep.items() if k.endswith("_ms")})
                + f", launches {rep['launches']}, both bit-equal to phase 4 True")
    finally:
        residency.materialize_tiles = materialize
        residency.TILE_CACHE_BYTES, tcore.STREAM_BYTES = saved_budget, saved_stream
        tstream._upload_stash.clear()
        torch.cuda.empty_cache()
    res["launches"] = sum(res[k]["launches"] for k in ("resident", "zarr_repeat", "retry",
                                                        "mono_repeat"))
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {res['phase_s']:.1f} s, fuse_translation_3d launches over the repeats "
        f"{res['launches']}")
    return res


def affine_plan_repeat(np, torch, tcore, tf, tea, fuse, sims, chunksize):
    """The cache phase's last part, on phase 7's 2D slide scan: a cold call
    (the caches emptied first) and its repeat, which takes its chunk plan
    from the plan cache and its tiles from the device tile cache; the plan
    stage of each, both outputs bit-equal, kernel 3 launched in both.
    Returns the results with the repeat's launches."""
    card = card_line()
    res = {}
    tcore.clear_device_tile_cache()
    outs = []
    for run in ("cold", "repeat"):
        tea.exact_affine_batch_2d.launches = 0
        with StageTimer(torch, tcore, tf, tea) as st:
            t0 = time.perf_counter()
            outs.append(fuse(sims, transform_key=KEY, output_chunksize=chunksize).data)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split = st.split_ms(t0, t1)
        # read after the timer has put the wrapper back
        res[run] = {"wall_s": t1 - t0, "launches": tea.exact_affine_batch_2d.launches, **split}
        if res[run]["launches"] < 2:
            raise AssertionError(f"cache: the affine {run} launched kernel 3 "
                                 f"{res[run]['launches']} times")
    same = bool(np.array_equal(outs[0], outs[1]))
    del outs
    if not same:
        raise AssertionError("cache: the affine repeat differs from its cold call")
    cold, rep = res["cold"], res["repeat"]
    log(f"{card}: cache: (f) 2d slide scan, per-tile affines: plan {cold['plan_ms']:.3f} ms "
        f"cold (caches emptied), {rep['plan_ms']:.3f} ms repeat; wall {cold['wall_s']:.3f} / "
        f"{rep['wall_s']:.3f} s, exact_affine_batch_2d launches {cold['launches']} / "
        f"{rep['launches']}, repeat bit-equal to the cold call {same}")
    res["launches"] = rep["launches"]
    return res


def api_phase(np, torch, tsi, tcore, tf, tea, fuse, sims, mono, lazy, mono_download_ms, work,
              chunk=512):
    """The API phase (after phase 5, lines start ``api:``): the public API
    slice at the north star's size. 1. ``prepare_block_fusion`` of phase 5's
    lazily opened zarr tiles into a zarr v2 array under ``work`` with
    ``output_chunksize=512`` (16 blocks), the blocks split between a creating
    and an attaching callable and run by ``utils.misc.process_batch_using_threads``
    (two workers), the array read back within 1 count of phase 4's
    monolithic output (a block's float origin can flip an integer rounding),
    ``fuse_translation_3d`` launched in the run. 2. ``fuse(sims=...,
    output_on_backend=True)`` of phase 4's in-memory tiles, cold and warm:
    a CUDA tensor bit-equal to the default call's numpy output (streamed:
    the host output uploaded once), the ``DeprecationWarning`` of ``sims=``;
    then the monolithic tier the same way, its download stage (a copy on the
    card) beside phase 4's. 3. ``mv_graph.get_greedy_colors`` and
    ``sims_are_far_apart`` on the 1024 tiles, ``si_utils.max_project_sim``
    of the device output along z held to ``amax`` of the tensor and to
    numpy's, and one zarr tile through ``serialize_zarr_backed_sim`` /
    ``deserialize_zarr_backed_sim``, read back byte for byte."""
    import itertools
    import warnings

    from multiview_stitcher_torch import mv_graph
    from multiview_stitcher_torch.fusion import _streaming, prepare_block_fusion
    from multiview_stitcher_torch.io import zarr_backend
    from multiview_stitcher_torch.utils import misc as misc_utils

    card = card_line()
    say = lambda msg: log(f"{card}: api: {msg}")  # noqa: E731
    t_phase = time.perf_counter()
    out = {}

    # 1. block-wise fusion into one shared zarr array
    url = str(work / "blocks.zarr")
    kwargs = {"images": lazy, "transform_key": KEY, "output_chunksize": chunk}
    t0 = time.perf_counter()
    creator = prepare_block_fusion(url, dict(kwargs))
    attacher = prepare_block_fusion(url, dict(kwargs), create_output=False)
    prepare_s = time.perf_counter() - t0
    nblocks = creator["nblocks"]
    ids = list(itertools.product(*(range(n) for n in nblocks)))
    work_items = [(creator["func"], b) for b in ids[::2]] + [(attacher["func"], b)
                                                             for b in ids[1::2]]
    # the block path's run: the five kernels' counts set to 0 just before
    for k in EXACT_WRAPPERS:
        getattr(tea, k).launches = 0
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    t0 = time.perf_counter()
    done = misc_utils.process_batch_using_threads(lambda it: it[0](it[1]), work_items,
                                                  n_workers=2)
    torch.cuda.synchronize()
    blocks_s = time.perf_counter() - t0
    counts = {k: getattr(tea, k).launches for k in EXACT_WRAPPERS}
    counts.update(fuse_translation_2d=tf.fuse_translation_2d.launches,
                  fuse_translation_3d=tf.fuse_translation_3d.launches)
    launches = counts["fuse_translation_3d"]
    if sorted(done) != ids or launches < len(ids) or sum(counts.values()) != launches:
        raise AssertionError(f"api: blocks {done} of {ids}, launches {counts}")
    blocks = np.asarray(zarr_backend.open_zarr_array(url))
    if blocks.shape != mono.shape or blocks.dtype != mono.dtype:
        raise AssertionError(f"api: blocks {blocks.shape} {blocks.dtype}, expected {mono.shape}")
    diff = np.abs(blocks.astype(np.int32) - mono.astype(np.int32))
    block_err, block_diff = int(diff.max()), int(np.count_nonzero(diff))
    del diff, blocks
    if block_err > UINT_COUNTS:
        raise AssertionError(f"api: the blocks differ from the monolithic output by {block_err}")
    # one block alone, split into the streaming pipeline and the rest (the
    # host plan over every view, the block's write)
    _streaming.last_telemetry = {}
    t0 = time.perf_counter()
    creator["func"](ids[len(ids) // 2])
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one = dict(_streaming.last_telemetry)
    mvox = mono.size / 1e6
    out["blocks"] = {"nblocks": nblocks, "blocks": len(ids), "prepare_s": prepare_s,
                     "one_block_s": one_s, "one_block_stream": one,
                     "wall_s": blocks_s, "mvox_s": mvox / blocks_s, "launches": int(launches),
                     "max_abs_err": block_err, "voxels_differ": block_diff,
                     "launch_counts": counts}
    say(f"prepare_block_fusion of {len(lazy)} zarr tiles, output {mono.shape}, chunks of {chunk}: "
        f"nblocks {nblocks} ({len(ids)} blocks, two callables, 2 threads), prepared in "
        f"{prepare_s:.2f} s, fused in {blocks_s:.2f} s ({mvox / blocks_s:.1f} Mvox/s out), "
        f"fuse_translation_3d launches {launches}; against the monolithic output "
        f"{block_diff} voxels differ (max {block_err} counts)")
    stream_part = (
        f"the streaming pipeline {one['elapsed_s']:.3f} s ({one['bands_total']} bands, NV "
        f"{one['nv']}, {one['up_bytes'] / 1e6:.1f} MB of tiles read and uploaded)"
        if one else "no streaming (one kernel call)"
    )
    say(f"block {ids[len(ids) // 2]} alone: {one_s:.3f} s, of which {stream_part}; the rest is "
        "the host plan over every view and the block's write")

    # 2. the output kept on the card, streamed and monolithic
    def timed(label, **kw):
        runs = {}
        for run in ("cold", "warm"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = fuse(transform_key=KEY, **kw)
                torch.cuda.synchronize()
                runs[run] = time.perf_counter() - t0
            if "sims" in kw and not any(issubclass(w.category, DeprecationWarning)
                                        for w in caught):
                raise AssertionError(f"api: {label}: fuse(sims=...) raised no DeprecationWarning")
        return res, runs

    tier = "streamed" if tcore._tile_bytes(sims) > tcore.STREAM_BYTES else "monolithic"
    default, default_s = timed("default", images=sims)
    on_dev, dev_s = timed("output_on_backend", sims=sims, output_on_backend=True)
    if not (isinstance(on_dev.data, torch.Tensor) and on_dev.data.is_cuda):
        raise AssertionError(f"api: output_on_backend gave {type(on_dev.data)}")
    if not np.array_equal(on_dev.data.cpu().numpy(), default.data):
        raise AssertionError("api: output_on_backend differs from the default output")
    del default
    saved = tcore.STREAM_BYTES
    tcore.STREAM_BYTES = 1 << 62
    try:
        with StageTimer(torch, tcore, tf, tea) as st:
            t0 = time.perf_counter()
            mono_dev = fuse(images=sims, transform_key=KEY, output_on_backend=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mono_split = st.split_ms(t0, t1)
    finally:
        tcore.STREAM_BYTES = saved
    if not (mono_dev.data.is_cuda and np.array_equal(mono_dev.data.cpu().numpy(), mono)):
        raise AssertionError("api: the monolithic output_on_backend differs from phase 4's")
    del mono_dev
    out["output_on_backend"] = {"streamed_cold_s": dev_s["cold"], "streamed_warm_s": dev_s["warm"],
                                "default_cold_s": default_s["cold"],
                                "default_warm_s": default_s["warm"],
                                "mono_wall_s": (t1 - t0), **{f"mono_{k}": v
                                                             for k, v in mono_split.items()},
                                "phase4_download_ms": mono_download_ms}
    say(f"fuse(sims=..., output_on_backend=True), {tier}: cold {dev_s['cold']:.3f} s, warm "
        f"{dev_s['warm']:.3f} s, against the default call's {default_s['cold']:.3f} / "
        f"{default_s['warm']:.3f} s; a CUDA tensor bit-equal to the default output, "
        "DeprecationWarning raised")
    say(f"monolithic tier with output_on_backend: wall {t1 - t0:.3f} s, split "
        + json.dumps({k: round(v, 3) for k, v in mono_split.items()})
        + f"; its download stage (a copy on the card) {mono_split.get('download_ms', 0):.3f} ms "
        f"against phase 4's {mono_download_ms:.3f} ms; bit-equal to phase 4's output")

    # 3. the new host names at this size
    t0 = time.perf_counter()
    colors = mv_graph.get_greedy_colors(sims, transform_key=KEY)
    colors_s = time.perf_counter() - t0
    n = int(round(len(sims) ** 0.5))
    bad = [(i, i + 1) for i in range(len(sims) - 1) if (i + 1) % n and colors[i] == colors[i + 1]]
    bad += [(i, i + n) for i in range(len(sims) - n) if colors[i] == colors[i + n]]
    if len(set(colors.values())) != 2 or bad:
        raise AssertionError(f"api: greedy colours {sorted(set(colors.values()))}, "
                             f"equal neighbours {bad[:5]}")
    t0 = time.perf_counter()
    far = [mv_graph.sims_are_far_apart(sims[0], s, KEY) for s in sims[1:]]
    far_s = time.perf_counter() - t0
    if far[0] or far[n - 1] or not far[-1]:
        raise AssertionError("api: sims_are_far_apart of tile 0 and its neighbours or its "
                             "opposite corner")
    t0 = time.perf_counter()
    proj = tsi.max_project_sim(on_dev, "z")
    torch.cuda.synchronize()
    proj_s = time.perf_counter() - t0
    ref = on_dev.data.to(torch.int32).amax(dim=0)
    if not (proj.data.is_cuda and proj.dims == ("y", "x")
            and torch.equal(proj.data.to(torch.int32), ref)
            and np.array_equal(proj.data.cpu().numpy(), mono.max(axis=0))):
        raise AssertionError("api: max_project_sim differs from amax of the device output")
    del on_dev, proj, ref
    t0 = time.perf_counter()
    payload = json.loads(json.dumps(tsi.serialize_zarr_backed_sim(lazy[37])))
    back = tsi.deserialize_zarr_backed_sim(payload)
    serial_s = time.perf_counter() - t0
    if (back.to_numpy().tobytes() != sims[37].data.tobytes() or back.origin != lazy[37].origin
            or back.dims != lazy[37].dims):
        raise AssertionError("api: a zarr tile read back through its serialized payload differs")
    out["host"] = {"greedy_colors_s": colors_s, "far_apart_s": far_s,
                   "far_apart": int(sum(far)), "max_project_s": proj_s,
                   "serialize_roundtrip_s": serial_s}
    say(f"get_greedy_colors of {len(sims)} tiles {colors_s:.2f} s (2 colours, no equal grid "
        f"neighbours); sims_are_far_apart of tile 0 and the other {len(far)} {far_s:.3f} s "
        f"({sum(far)} far apart); max_project_sim of the device output along z "
        f"{proj_s * 1e3:.1f} ms on the card (equal to amax and to numpy's); a zarr tile "
        f"serialized and read back in {serial_s * 1e3:.1f} ms, byte for byte")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {out['phase_s']:.1f} s")
    return out


def rot2(np, theta, scale=1.0):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]]) * scale


def roty(np, theta, yscale=1.0):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s], [0, yscale, 0], [s, 0, c]])


def coupled3(np, seed):
    """The reference tests' two coupled families: weak near-identity coupling
    in every entry, and a strong two-axis rotation."""
    if seed == 0:
        return np.eye(3) + np.random.default_rng(0).normal(0, 0.02, (3, 3))
    cz, sz = np.cos(0.2), np.sin(0.2)
    return roty(np, 0.4) @ np.array([[1, 0, 0], [0, cz, -sz], [0, sz, cz]])


def exact_small_cases(np):
    """(kind, label, source shape, out shape, mats, offs, extents) of the
    small cases: the reference's test maps one by one, then a batch of them
    with a map that downscales by 4, true extents below the source shape and
    an output shape that is no multiple of the kernel blocks."""
    cases = []
    maps2 = [(rot2(np, th, sc), off) for th, sc, off in [
        (0.3, 1.0, (2.3, -4.7)), (0.0, 1.0, (0.5, 0.5)),
        (-0.8, 1.3, (10.0, 3.2)), (1.4, 0.7, (-3.0, 8.1)),
    ]]
    maps_sepy = [(roty(np, th, 1.1), (1.2, -2.3, 3.4)) for th in (0.4, -0.7, 0.0, 1.2)]
    maps_gen = [(coupled3(np, seed), (1.2, -2.3, 3.4)) for seed in (0, 1)]
    for kind, maps, src, out in (
        ("2d", maps2, (60, 90), (50, 80)),
        ("sepy", maps_sepy, (20, 30, 40), (18, 25, 35)),
        ("general", maps_gen, (20, 30, 40), (18, 25, 35)),
    ):
        ndim = len(src)
        for i, (M, off) in enumerate(maps):
            cases.append((kind, f"map{i}", src, out, M[None], np.array([off]), np.array([src])))
        down = np.diag([4.0] * ndim) if kind != "general" else 4.0 * coupled3(np, 0)
        mats = np.stack([m for m, _ in maps] + [down])
        offs = np.array([o for _, o in maps] + [[0.25] * ndim])
        extents = np.array([[s - (b % 3) * 5 for s in src] for b in range(len(mats))])
        odd = tuple(o - 7 for o in out)
        cases.append((kind, "batch", src, odd, mats, offs, extents))
    return cases


def exact_wrappers(tea):
    return {
        "2d": (tea.exact_affine_batch_2d, tea.exact_affine_batch_2d_plain),
        "sepy": (tea.exact_affine_batch_3d_sepy, tea.exact_affine_batch_3d_sepy_plain),
        "general": (tea.exact_affine_batch_3d_general, tea.exact_affine_batch_3d_general_plain),
    }


def compare_exact(np, torch, tea, worst, kind, label, args, kw, route=None):
    """One exact-affine wrapper call against its plain version on the card:
    identical masks, values within EXACT_ATOL. ``route`` names what the
    kernel must have done: "shared" (no block took the large-footprint
    route, some staged a box) or "gather" (some block took it)."""
    fn, plain = exact_wrappers(tea)[kind]
    tea.record_routes(args[0].device)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    routes = tea.read_routes()
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == ref.shape
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    if not np.array_equal(np.isnan(g), np.isnan(r)):
        raise AssertionError(f"exact {kind} {label}: masks differ")
    if not np.array_equal(g == 0, r == 0):
        raise AssertionError(f"exact {kind} {label}: zero masks differ")
    err = max_err(np.nan_to_num(g), np.nan_to_num(r), np)
    inside = float(np.mean(~np.isnan(g) & (g != 0)))
    ok = err < EXACT_ATOL and inside > 0.005
    took = " routes " + "/".join(f"{k} {v}" for k, v in routes.items())
    log(f"  exact {kind:7s} {label:26s}: inside {inside:.2f} "
        f"max_abs_err={err:.3g}{took} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"exact {kind} {label}: kernel != plain ({err}, inside {inside})")
    if route == "shared" and (routes["gather"] or not routes["shared"]):
        raise AssertionError(f"exact {kind} {label}: expected the shared-memory route, got {routes}")
    if route == "gather" and not routes["gather"]:
        raise AssertionError(f"exact {kind} {label}: expected the large-footprint route, got {routes}")
    worst[kind] = max(worst[kind], err)
    return got, ref


def check_exact_small_cases(np, torch, tea):
    """Phase 3, exact-affine kernels: each against its plain version on the
    card. Masks must be identical, values within EXACT_ATOL."""
    wrappers = exact_wrappers(tea)
    worst = {k: 0.0 for k in wrappers}
    rng = np.random.default_rng(1)

    def compare(kind, label, args, kw):
        compare_exact(np, torch, tea, worst, kind, label, args, kw)

    for kind, label, src, out, mats, offs, extents in exact_small_cases(np):
        B, ndim = len(mats), len(src)
        base = rng.random((B,) + src) * 99 + 1  # strictly positive: 0 marks the mask
        tables = (mats.astype(np.float32), offs.astype(np.float32), extents.astype(np.float32), out)
        # int16 and float64 sources are cast to float32 on the card (F1)
        dtypes = ((np.float32, np.uint16, np.uint8, np.int16, np.float64) if label == "batch"
                  else (np.float32,))
        for dtype in dtypes:
            data = torch.from_numpy(base.astype(dtype)).cuda()
            for cval in (float("nan"), 0.0):
                compare(kind, f"{label} {np.dtype(dtype).name} cval={cval}", (data, *tables),
                        {"cval": cval})
        if label != "batch":
            continue
        # float input with NaN and inf goes through nan_to_num
        holed = base.astype(np.float32)
        holed[0][(slice(None),) * (ndim - 2) + (10, 12)] = np.nan
        holed[1][(slice(None),) * (ndim - 2) + (12, 15)] = np.inf
        fn, plain = wrappers[kind]
        got = fn(torch.from_numpy(holed).cuda(), *tables)
        ref = plain(torch.from_numpy(holed).cuda(), *tables)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not bool(
            torch.isfinite(got[~torch.isnan(got)]).all()
        ):
            raise AssertionError(f"exact {kind}: NaN/inf input is not read through nan_to_num")
        # the same batch sampled out of a larger stack, with a padding slot
        stack = rng.random((3,) + tuple(n + 9 for n in src)) * 99 + 1
        stack = torch.from_numpy(stack.astype(np.uint16)).cuda()
        tile_idx = np.arange(B + 1, dtype=np.int32) % 3
        starts = rng.integers(0, 10, (B + 1, ndim)).astype(np.int32)
        pad = lambda x, fill: np.concatenate([x, fill[None]]).astype(np.float32)  # noqa: E731
        args = (stack, pad(mats, np.eye(ndim)), pad(offs, np.zeros(ndim)),
                pad(extents, np.ones(ndim)), out)
        kw = {"tile_idx": tile_idx, "starts": starts,
              "valid": np.arange(B + 1) < B}
        compare(kind, "stack uint16 cval=nan", args, dict(kw, cval=float("nan")))
        compare(kind, "stack uint16 cval=0", args, dict(kw, cval=0.0))
        last = fn(*args, **dict(kw, cval=float("nan")))[B]
        if not bool(torch.isnan(last).all()):
            raise AssertionError(f"exact {kind}: a padding slot was sampled")
        # the host-slab route's input: uint16 windows zero-padded beyond their
        # extents, one item each, and a padding slot, with no tile_idx
        slabs = np.zeros((B + 1,) + src, np.uint16)
        for b in range(B):
            inside_ext = tuple(slice(0, int(n)) for n in extents[b])
            slabs[b][inside_ext] = base[b][inside_ext].astype(np.uint16)
        compare(kind, "slabs uint16 cval=nan", (torch.from_numpy(slabs).cuda(),) + args[1:],
                {"valid": kw["valid"], "cval": float("nan")})
    check_exact_2d_routes(np, torch, tea, worst)
    check_exact_3d_routes(np, torch, tea, worst)
    return worst


def about_box_centre(np, lin, src, out):
    """Offset that sends the centre of an ``out`` grid to the centre of ``src``."""
    return (np.asarray(src) - 1) / 2 - lin @ ((np.asarray(out) - 1) / 2)


def check_exact_2d_routes(np, torch, tea, worst):
    """Phase 3, the cases aimed at the 2D kernel's staged source boxes; each
    line prints the routes the kernel's blocks took."""
    rng = np.random.default_rng(3)

    def positive(shape, dtype):
        return torch.from_numpy((rng.random(shape) * 99 + 1).astype(dtype)).cuda()

    def tables(mats, offs, extents):
        return tuple(np.asarray(x, np.float32) for x in (mats, offs, extents))

    def compare(label, args, kw, route=None):
        return compare_exact(np, torch, tea, worst, "2d", label, args, kw, route)

    # rotations by 47 and 92 degrees and a near-identity map in one batch per
    # source dtype. W = 176 takes 16-byte loads for every dtype, W = 171 for
    # none; the output is several tiles wide and high, a multiple of 4 wide
    # (16-byte fills) or not, and a multiple of a tile in neither axis
    angles = (47, 92, 0.4)
    rots = np.stack([rot2(np, np.deg2rad(a), 1.03) for a in angles])
    for src, out in (((150, 176), (139, 164)), ((150, 171), (139, 163))):
        offs = np.stack([about_box_centre(np, m, src, out) + (0.3, -0.4) for m in rots])
        ext = np.array([[n - 3 * b for n in src] for b in range(len(rots))])
        for dtype in (np.float32, np.uint16, np.uint8):
            data = positive((len(rots),) + src, dtype)
            for cval in (float("nan"), 0.0):
                compare(f"rot W={src[1]} OX={out[1]} {np.dtype(dtype).name} cval={cval}",
                        (data, *tables(rots, offs, ext), out), {"cval": cval}, "shared")
    # NaN and inf in a float source are read through nan_to_num while staging
    src, out = (150, 171), (139, 163)
    holed = (rng.random((len(rots),) + src) * 99 + 1).astype(np.float32)
    holed[0, 70:80, 60] = np.nan
    holed[1, 75, 80:90] = np.inf
    holed[2, 40, 50] = -np.inf
    offs = np.stack([about_box_centre(np, m, src, out) for m in rots])
    args = (torch.from_numpy(holed).cuda(), *tables(rots, offs, [src] * len(rots)), out)
    got = tea.exact_affine_batch_2d(*args)
    ref = tea.exact_affine_batch_2d_plain(*args)
    torch.cuda.synchronize()
    small = (got.abs() < 1e6) & (ref.abs() < 1e6)
    if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not bool(
        torch.isfinite(got[~torch.isnan(got)]).all()
    ) or float((got - ref)[small].abs().max()) >= EXACT_ATOL:
        raise AssertionError("exact 2d: NaN/inf input is not read through nan_to_num")
    log("  exact 2d      rot float32 with NaN and inf: read through nan_to_num ok")

    # boxes over the shared-memory budget: a map that downscales by 4 and a
    # shear of y by 3 x; a map that downscales by 2 still fits
    src_big, out_small = (600, 700), (139, 163)
    shear = np.eye(2)
    shear[0, 1] = 3.0
    big = positive((3,) + src_big, np.uint16)
    mats = np.stack([np.diag([4.0, 4.0]), shear, rot2(np, 0.2, 4.0)])
    offs = np.array([(0.25, 0.5), (0.4, 0.3), (100.2, 7.6)])
    compare("downscale 4 and shear uint16", (big, *tables(mats, offs, [src_big] * 3), out_small),
            {}, "gather")
    compare("downscale 2 uint16",
            (big[:1], *tables([np.diag([2.0, 2.0])], [(0.25, 0.5)], [src_big]), out_small),
            {}, "shared")

    # windows of a stack: one spans its source, so that the boxes of the edge
    # tiles are cut by every edge of the stack; one sits at the far corner;
    # between the valid items one marked invalid and one whose tile_idx lies
    # outside the stack (a tensor, which the wrapper does not read back)
    stack_shape = (90, 112)
    out = (101, 131)
    stack = positive((3,) + stack_shape, np.uint16)
    tilt = rot2(np, np.deg2rad(12))
    far = np.array(stack_shape) - 8
    mats = np.stack([tilt, np.eye(2), rot2(np, 0.3), np.eye(2), rot2(np, -0.2)])
    offs = np.stack([about_box_centre(np, tilt, stack_shape, out), np.zeros(2),
                     (-2.5, -3.5), np.zeros(2), (1.0, -4.0)])
    ext = np.array([stack_shape, (1, 1), (8, 8), (1, 1), (80, 100)])
    kw = {"tile_idx": torch.tensor([0, 1, 2, 5, 1], dtype=torch.int32).cuda(),
          "starts": np.array([(0, 0), (0, 0), far, (0, 0), (3, 2)], np.int32),
          "valid": np.array([True, False, True, True, True])}
    for cval in (float("nan"), 0.0):
        got, _ = compare(f"stack edges cval={cval}", (stack, *tables(mats, offs, ext), out),
                         dict(kw, cval=cval), "shared")
        for b in (1, 3):
            unsampled = torch.isnan(got[b]) if cval != cval else got[b] == 0
            if not bool(unsampled.all()):
                raise AssertionError(f"exact 2d: item {b} of the stack batch was sampled")

    # the blending-weight launch of fuse(): 5 x 5 f32 grids, extent 5, cval 0
    out = (139, 163)
    grids = positive((len(rots), 5, 5), np.float32)
    wm = rots * (4.0 / 170)
    wo = np.stack([about_box_centre(np, m, (5, 5), out) for m in wm])
    compare("5 x 5 weight grids cval=0",
            (grids, *tables(wm, wo, np.full((len(rots), 2), 5.0)), out), {"cval": 0.0}, "shared")


def check_exact_3d_routes(np, torch, tea, worst):
    """Phase 3, the cases aimed at the 3D kernels' staged source boxes. Both
    3D kernels take every y-decoupled case; each line prints the routes the
    kernel's blocks (general) or runs of y rows (y-decoupled) took."""
    rng = np.random.default_rng(2)
    both = ("sepy", "general")

    def positive(shape, dtype):
        return torch.from_numpy((rng.random(shape) * 99 + 1).astype(dtype)).cuda()

    def tables(mats, offs, extents):
        return tuple(np.asarray(x, np.float32) for x in (mats, offs, extents))

    # rotations about y, all in one batch per source dtype; the source rows
    # take 16-byte loads for every dtype (W = 48), the output shape is no
    # multiple of a tile in any axis
    src, out = (44, 26, 48), (37, 21, 45)
    angles = (47, 92, 137, -133)
    rots = np.stack([roty(np, np.deg2rad(a), 1.07) for a in angles])
    offs = np.stack([about_box_centre(np, m, src, out) + (0.3, -0.4, 0.2) for m in rots])
    ext = np.array([[s - 2 * b for s in src] for b in range(len(rots))])
    for dtype in (np.float32, np.uint16, np.uint8):
        data = positive((len(rots),) + src, dtype)
        for kind in both:
            for cval in (float("nan"), 0.0):
                # the y-decoupled kernel stages these boxes; under them the
                # general kernel's 32 x 8 tiles span so many planes that it
                # stages runs of 4 planes or takes the large-footprint route
                compare_exact(np, torch, tea, worst, kind,
                              f"rot y {np.dtype(dtype).name} cval={cval}",
                              (data, *tables(rots, offs, ext), out), {"cval": cval},
                              "shared" if kind == "sepy" else None)
    # the same on rows that take scalar loads (W = 45), NaN and inf in the source
    src_odd = (44, 26, 45)
    holed = (rng.random((len(rots),) + src_odd) * 99 + 1).astype(np.float32)
    offs_odd = np.stack([about_box_centre(np, m, src_odd, out) for m in rots])
    args = (torch.from_numpy(holed).cuda(), *tables(rots, offs_odd, [src_odd] * len(rots)), out)
    for kind in both:
        compare_exact(np, torch, tea, worst, kind, "rot y float32 odd rows", args, {},
                      "shared" if kind == "sepy" else None)
    holed[0, :, 10, 12] = np.nan
    holed[1, :, 12, 15] = np.inf
    holed[2, 20, :, 30] = -np.inf
    args = (torch.from_numpy(holed).cuda(),) + args[1:]
    for kind in both:
        fn, plain = exact_wrappers(tea)[kind]
        got, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not bool(
            torch.isfinite(got[~torch.isnan(got)]).all()
        ):
            raise AssertionError(f"exact {kind}: NaN/inf input is not read through nan_to_num")
        small = (got.abs() < 1e6) & (ref.abs() < 1e6)
        if float((got - ref)[small].abs().max()) >= EXACT_ATOL:
            raise AssertionError(f"exact {kind}: values beside NaN/inf input differ")
    log("  exact sepy/general rot y float32 with NaN and inf: read through nan_to_num ok")

    # couplings of 0.05 in every entry: the general kernel's box fits for runs
    # of 8 of its tile's 16 planes
    mats = np.stack([np.eye(3) + 0.05 * s for s in (np.ones((3, 3)), -np.ones((3, 3)))])
    offs_c = np.stack([about_box_centre(np, m, src, out) for m in mats])
    compare_exact(np, torch, tea, worst, "general", "couplings of 0.05 uint16",
                  (positive((2,) + src, np.uint16), *tables(mats, offs_c, [src] * 2), out), {},
                  "shared")

    # a shear of z by 8 x: a tile's box is some 270 planes deep and exceeds
    # the shared-memory budget; y-decoupled, so both kernels take it
    src_tall, out_sh = (300, 12, 40), (18, 11, 37)
    shear = np.eye(3)
    shear[0, 2] = 8.0
    args = (positive((2,) + src_tall, np.uint16),
            *tables([shear, shear], [(0.4, 0.3, 0.6), (3.2, 0.7, 1.5)], [src_tall] * 2), out_sh)
    for kind in both:
        compare_exact(np, torch, tea, worst, kind, "shear 8 uint16", args, {}, "gather")
    # fully coupled: the shear on top of the reference's two-axis rotation
    args = (args[0], *tables([coupled3(np, 1) @ shear] * 2, [(30.0, 2.0, 3.0), (45.5, 1.0, 0.5)],
                             [src_tall] * 2), out_sh)
    compare_exact(np, torch, tea, worst, "general", "coupled shear uint16", args, {}, "gather")

    # windows of a stack: one spans its source, so that the box of an edge
    # tile is cut by every face of the stack; one sits at the far corner;
    # between the valid items one marked invalid and one whose tile_idx lies
    # outside the stack (a tensor, which the wrapper does not read back)
    stack_shape = (24, 14, 32)
    stack = positive((3,) + stack_shape, np.uint16)
    tilt = roty(np, np.deg2rad(12))
    far = np.array(stack_shape) - 8
    mats = np.stack([tilt, np.eye(3), roty(np, 0.3), np.eye(3), roty(np, -0.2)])
    offs = np.stack([about_box_centre(np, tilt, stack_shape, out), np.zeros(3),
                     (-2.5, -1.5, -3.5), np.zeros(3), (1.0, 2.0, -4.0)])
    ext = np.array([stack_shape, (1, 1, 1), (8, 8, 8), (1, 1, 1), (20, 14, 30)])
    kw = {"tile_idx": torch.tensor([0, 1, 2, 5, 1], dtype=torch.int32).cuda(),
          "starts": np.array([(0, 0, 0), (0, 0, 0), far, (0, 0, 0), (3, 0, 2)], np.int32),
          "valid": np.array([True, False, True, True, True])}
    for kind in both:
        for cval in (float("nan"), 0.0):
            got, _ = compare_exact(np, torch, tea, worst, kind, f"stack faces cval={cval}",
                                   (stack, *tables(mats, offs, ext), out), dict(kw, cval=cval),
                                   "shared")
            for b in (1, 3):
                unsampled = torch.isnan(got[b]) if cval != cval else got[b] == 0
                if not bool(unsampled.all()):
                    raise AssertionError(f"exact {kind}: item {b} of the stack batch was sampled")

    # the blending-weight launch of fuse(): 5^3 f32 grids, extent 5, cval 0
    grids = positive((len(rots), 5, 5, 5), np.float32)
    wm = rots * (4.0 / 40)
    wo = np.stack([about_box_centre(np, m, (5, 5, 5), out) for m in wm])
    for kind in both:
        compare_exact(np, torch, tea, worst, kind, "5^3 weight grids cval=0",
                      (grids, *tables(wm, wo, np.full((len(rots), 3), 5.0)), out), {"cval": 0.0},
                      "shared")


def about_centre(np, lin, centre):
    """Homogeneous affine with linear part ``lin`` that keeps ``centre`` fixed."""
    ndim = len(centre)
    p = np.eye(ndim + 1)
    p[:ndim, :ndim] = lin
    p[:ndim, ndim] = np.asarray(centre) - lin @ np.asarray(centre)
    return p


def with_affine(tsi, sims, params):
    for sim, p in zip(sims, params):
        tsi.set_sim_affine(sim, p, transform_key=KEY)
    return sims


def multiview_sims(np, tsi, shape, angles_deg, seed):
    """Views of one (z, y, x) volume rotated about y through the common
    centre: the light-sheet multi-view geometry. The content is a smooth
    volume at a quarter of the size, repeated 4 x per axis, rolled per view."""
    rng = np.random.default_rng(seed)
    base = smooth_tile(np, rng, tuple(n // 4 for n in shape))
    for axis in range(3):
        base = np.repeat(base, 4, axis=axis)
    centre = [(n - 1) / 2 for n in shape]
    sims, params = [], []
    for iv, deg in enumerate(angles_deg):
        data = np.ascontiguousarray(np.roll(base, 37 * iv, axis=2))
        sims.append(tsi.get_sim_from_array(data, dims=["z", "y", "x"]))
        params.append(about_centre(np, roty(np, np.deg2rad(deg)), centre))
    return with_affine(tsi, sims, params)


def affine_grid_sims(np, tsi, ndim, n, tile, overlap, seed, linear_part):
    """n x n translation grid whose every tile also carries its own linear
    part ``linear_part(rng)``, applied about the tile's centre."""
    sims = grid_sims(np, tsi, ndim, n, tile, overlap, seed)
    rng = np.random.default_rng(seed + 100)
    sdims = ["z", "y", "x"][-ndim:]
    params = []
    for sim in sims:
        centre = [sim.origin[d] + (tile - 1) / 2 for d in sdims]
        params.append(about_centre(np, linear_part(rng), centre))
    return with_affine(tsi, sims, params)


def time_grid_sample_ms(np, torch, tiles, args, kw, ndim):
    """One ``grid_sample`` call (bilinear, zero padding, align_corners=True,
    f32 input) over the valid items of a main-path batch: a yardstick for
    time only. The f32 copies of the items' tiles and the sampling grid are
    made before the timed call."""
    import torch.nn.functional as F

    keep = np.flatnonzero(kw["valid"])
    dev = tiles.device
    mats = torch.as_tensor(args[1][keep], dtype=torch.float32, device=dev)
    offs = torch.as_tensor(args[2][keep] + kw["starts"][keep], dtype=torch.float32, device=dev)
    out_shape = args[4]
    idx = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev) for n in out_shape], indexing="ij"
    ), dim=-1)
    coords = torch.einsum("brc,...c->b...r", mats, idx) + offs.reshape((-1,) + (1,) * ndim + (ndim,))
    sizes = torch.tensor(tiles.shape[1:], dtype=torch.float32, device=dev)
    grid = (2 * coords / (sizes - 1) - 1).flip(-1).contiguous()  # (x, y[, z]) order
    src = torch.stack([tiles[int(i)].to(torch.float32) for i in kw["tile_idx"][keep]])[:, None]
    F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def affine_main_path(np, torch, tcore, tf, tea, fuse, label, sims, chunksize, kind):
    """Phase 7: one affine main path through fuse(), checked and timed."""
    from multiview_stitcher_torch import residency

    names = {"2d": EXACT_WRAPPERS[0], "sepy": EXACT_WRAPPERS[1], "general": EXACT_WRAPPERS[2]}
    wrapper = getattr(tea, names[kind])
    plain = getattr(tea, names[kind] + "_plain")
    ndim = len(sims[0].data.shape)

    def counts():
        return {k: getattr(tea, n).launches for k, n in names.items()}

    t0 = time.perf_counter()
    cold = fuse(sims, transform_key=KEY, output_chunksize=chunksize)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del cold

    # the main path's run: counts set to 0 just before, read just after. The
    # cold call left the tile stack in the device tile cache: it is dropped,
    # so that this call's upload stage measures the upload
    tcore.clear_device_tile_cache()
    for n in names.values():
        getattr(tea, n).launches = 0
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    with StageTimer(torch, tcore, tf, tea) as st:
        t0 = time.perf_counter()
        fused = fuse(sims, transform_key=KEY, output_chunksize=chunksize)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        warm_s = t1 - t0
        split = st.split_ms(t0, t1)
    launched = counts()
    if launched[kind] < 2 or any(v for k, v in launched.items() if k != kind) or (
        tf.fuse_translation_2d.launches or tf.fuse_translation_3d.launches
    ):
        raise AssertionError(f"{label}: launches {launched}, expected only the {kind} kernel")

    out = fused.data
    top = max(int(s.data.max()) for s in sims)
    covered = float(np.mean(out > 0))
    if out.dtype != np.uint16 or out.ndim != ndim or int(out.max()) > top or covered < 0.3:
        raise AssertionError(
            f"{label}: output {out.shape} {out.dtype}, max {out.max()} (inputs {top}), "
            f"covered {covered:.2f}"
        )
    log(f"{label}: output {out.shape} {out.dtype}, covered {covered:.2f}, cold fuse "
        f"{cold_s:.3f} s, warm fuse {warm_s:.3f} s, launches {launched[kind]}")
    log(f"{label}: warm split " + json.dumps({k: round(v, 3) for k, v in split.items()}))

    # the same fuse with the wrappers swapped for their plain versions on the card
    saved = {n: getattr(tea, n) for n in EXACT_WRAPPERS}
    try:
        for n in EXACT_WRAPPERS:
            setattr(tea, n, getattr(tea, n + "_plain"))
        t0 = time.perf_counter()
        ref = fuse(sims, transform_key=KEY, output_chunksize=chunksize).data
        torch.cuda.synchronize()
        plain_fuse_s = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(tea, n, fn)
    if counts() != launched:
        raise AssertionError(f"{label}: the plain run launched a kernel")
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    err, n_diff = int(diff.max()), int(np.count_nonzero(diff))
    del ref, diff
    if err > UINT_COUNTS:
        raise AssertionError(f"{label}: fused output differs from the plain-version run by {err}")
    # a repeat call reads the stack from the device tile cache: no upload,
    # the same output
    uploaded = residency.tile_upload_bytes
    t0 = time.perf_counter()
    again = fuse(sims, transform_key=KEY, output_chunksize=chunksize).data
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    if residency.tile_upload_bytes != uploaded or not np.array_equal(again, out):
        raise AssertionError(
            f"{label}: the repeat fuse uploaded {residency.tile_upload_bytes - uploaded} bytes, "
            f"output equal: {np.array_equal(again, out)}"
        )
    del again
    log(f"{label}: repeat fuse from the device tile cache {repeat_s:.3f} s, 0 bytes uploaded, "
        f"output bit-equal")

    # the fullest batch's data resample. The kernel is timed on tables packed
    # once (a wrapper call packs them anew, which takes the host longer than
    # the kernel takes the card), warm and on a cold L2; the wrapper's own
    # call, tables on the card and on the host, is timed beside it
    args, kw = st.kernel_call
    tiles = args[0]
    dev_args = (tiles,) + tuple(torch.as_tensor(x).cuda() for x in args[1:4]) + (args[4],)
    dev_kw = {k: (torch.as_tensor(v).cuda() if k != "cval" else v) for k, v in kw.items()}
    packed = tea._check_args(ndim, tiles, *args[1:5], kw["cval"], kw["tile_idx"], kw["starts"],
                             kw["valid"])
    entry = tea._ENTRY_POINTS[list(names).index(kind)]
    kernel_ms = time_kernel_ms(torch, tea._launch, (entry, packed), {}, reps=20)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=tiles.device)
    cold_l2_ms = time_kernel_ms(torch, tea._launch, (entry, packed), {}, reps=10, flush=flush)
    del flush
    # the same batch's blending-weight launch: 5^ndim sources, every voxel of a
    # valid item inside
    wargs, wkw = st.weights_call
    wpacked = tea._check_args(ndim, torch.as_tensor(wargs[0]).cuda(), *wargs[1:5], wkw["cval"],
                              wkw.get("tile_idx"), wkw.get("starts"), wkw.get("valid"))
    weights_ms = time_kernel_ms(torch, tea._launch, (entry, wpacked), {}, reps=20)
    wrapper_ms = time_kernel_ms(torch, wrapper, dev_args, dev_kw, reps=10)
    t0 = time.perf_counter()
    for _ in range(20):
        wrapper(*args, **kw)
    torch.cuda.synchronize()
    wrapper_host_tables_ms = (time.perf_counter() - t0) / 20 * 1e3
    tea.record_routes(tiles.device)
    got = wrapper(*dev_args, **dev_kw)
    torch.cuda.synchronize()
    routes = tea.read_routes()
    if routes["gather"] or not routes["shared"]:
        raise AssertionError(f"{label}: main-path blocks off the shared-memory route: {routes}")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain(*dev_args, **dev_kw)  # warm
    e0.record()
    ref_b = plain(*dev_args, **dev_kw)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    if not torch.equal(torch.isnan(got), torch.isnan(ref_b)):
        raise AssertionError(f"{label}: batch masks differ from the plain version")
    batch_err = float((torch.nan_to_num(got) - torch.nan_to_num(ref_b)).abs().max())
    # uint16 data up to `top`: the f32 ulps of the coordinate scale with the value
    if batch_err > EXACT_ATOL * max(top, 100) / 100:
        raise AssertionError(f"{label}: batch differs from the plain version by {batch_err}")
    inside = int((~torch.isnan(got)).sum())
    del ref_b
    library_ms = time_grid_sample_ms(np, torch, tiles, args, kw, ndim)

    n_valid = int(kw["valid"].sum())
    voxels = n_valid * int(np.prod(args[4]))
    window_bytes = int(
        np.prod(np.asarray(args[3])[kw["valid"]], axis=1).sum() * tiles.element_size()
    )
    nbytes = got.numel() * 4 + window_bytes + sum(
        int(np.asarray(x).nbytes) for x in list(args[1:4]) + [kw["tile_idx"], kw["starts"]]
    )
    ops = exact_ops(ndim, voxels, inside)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    log(f"{label}: fullest batch {n_valid} of {len(kw['valid'])} items x {tuple(args[4])}, "
        f"kernel {kernel_ms:.4f} ms warm, {cold_l2_ms:.4f} ms on a cold L2, its weights launch "
        f"{weights_ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"grid_sample {library_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms; wrapper call "
        f"{wrapper_ms:.3f} ms with tables on the card, {wrapper_host_tables_ms:.3f} ms (host "
        f"clock) with host tables; routes {routes}; plain-version fuse {plain_fuse_s:.2f} s, "
        f"{n_diff} voxels differ by 1 count, batch max_abs_err {batch_err:.3g}")
    return {
        "launches": int(launched[kind]),
        "max_abs_err": batch_err,
        "fused_max_abs_err_counts": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "cold_l2_ms": cold_l2_ms,
        "weights_ms": weights_ms,
        "wrapper_ms": wrapper_ms,
        "wrapper_host_tables_ms": wrapper_host_tables_ms,
        "routes": routes,
        "cold_fuse_s": cold_s,
        "warm_fuse_s": warm_s,
        "repeat_fuse_s": repeat_s,
        "plain_fuse_s": plain_fuse_s,
        **split,
        "bytes": nbytes,
        "batch_items": n_valid,
        "batch_voxels_inside": inside,
        "out_shape": list(out.shape),
    }


class GeneralTimer(StageTimer):
    """Splits one fuse() call of the general fusion path into plan, upload,
    resample (views and blending weights), weights (the weights function),
    reduce (the blend of the builtin functions, or the fusion function) and
    download, by wrapping the stages fusion._core calls, its own and
    residency's copies (CUDA events, summed over the call); and counts the
    calls of each, and of the tiers' units of work (host-tier chunks, gather
    batches). No kernel wrapper is touched."""

    STAGES = {
        "tiles_to_device": "upload",
        "_resample_views": "resample",
        "_resample_tiles": "resample",
        "_reduce_views": "reduce",
        "func_ignore_nan_warning": "reduce",
        "download": "download",
        "_fuse_views": None,
        "_fuse_chunk_batch_kernel_gather": None,
        "_execute_fusion_plan_tiles": None,
    }

    def __init__(self, torch, tcore):
        super().__init__(torch, tcore, None, None)
        self.calls = {}

    def _counted(self, name, fn):
        def before(a, k):
            self.calls[name] = self.calls.get(name, 0) + 1
            if self.t_upload_start is None and self.STAGES.get(name):
                self.t_upload_start = time.perf_counter()

        return self._timed(name, fn, before)

    def weights(self, func):
        """``func`` timed as the "weights" stage; its signature and halo
        declaration stay readable (``functools.wraps``)."""
        import functools

        return functools.wraps(func)(self._counted("weights", func))

    def __enter__(self):
        from multiview_stitcher_torch import residency

        self._saved = {}
        for n in self.STAGES:
            owner = residency if hasattr(residency, n) else self.tcore
            self._saved[n] = (owner, getattr(owner, n))
            setattr(owner, n, self._counted(n, self._saved[n][1]))
        return self

    def __exit__(self, *exc):
        for n, (owner, fn) in self._saved.items():
            setattr(owner, n, fn)
        return False

    def split_ms(self, t_start, t_end):
        self.torch.cuda.synchronize()
        out = {"plan_ms": ((self.t_upload_start or t_end) - t_start) * 1e3}
        for name, stage in {"weights": "weights", **self.STAGES}.items():
            if stage and name in self.events:
                ms = sum(e0.elapsed_time(e1) for e0, e1 in self.events[name])
                out[f"{stage}_ms"] = out.get(f"{stage}_ms", 0.0) + ms
        out["other_ms"] = (t_end - t_start) * 1e3 - sum(out.values())
        return out


def window_props(osp, sdims, start, size):
    """Stack properties of the output window of ``size`` pixels (one count for
    every axis, or one per axis) that starts ``start`` pixels into ``osp``:
    on the same grid, so a fuse of the window plans the same chunks (with
    their halos) as the whole output's."""
    sizes = [size] * len(sdims) if isinstance(size, int) else list(size)
    return {
        "shape": dict(zip(sdims, sizes)),
        "spacing": dict(osp["spacing"]),
        "origin": {d: osp["origin"][d] + start[i] * osp["spacing"][d] for i, d in enumerate(sdims)},
    }


def general_window_err(np, got, ref, label):
    """Max abs difference of a window against its CPU fuse, within 1 count on
    integers, rtol 1e-4 / atol 1e-3 on floats."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{label}: window {got.shape} {got.dtype} against the CPU's "
                             f"{ref.shape} {ref.dtype}")
    if np.issubdtype(got.dtype, np.integer):
        err = int(np.abs(got.astype(np.int64) - ref.astype(np.int64)).max())
        ok = err <= UINT_COUNTS
    else:
        err = float(np.abs(got.astype(np.float64) - ref).max())
        ok = bool(np.all(np.abs(got - ref) <= F32_ATOL + F32_RTOL * np.abs(ref)))
    if not ok:
        raise AssertionError(f"{label}: window differs from the CPU's fuse by {err}")
    return err


def general_case(np, torch, tcore, tea, tf, fuse, label, sims, kw, window, cpu_sims=None,
                 timed_weights=False, key=KEY, say=None):
    """One case of the general phase: a cold and a warm fuse() on the card,
    the warm one split by stage with the five kernels' launch counts set to 0
    just before it and read just after, and ``window`` ((start, size) in
    output pixels, chunk-aligned) held to the same fuse() with
    device="cpu" (on ``cpu_sims``, the views that reach it, by default all;
    ``window`` may be a function of the output's shape). Views are placed by
    ``key``; ``say`` writes a line (default: ``general:``
    lines)."""
    say = say or (lambda msg: log(f"general: {msg}"))
    sdims = sims[0].spatial_dims
    t0 = time.perf_counter()
    cold = fuse(sims, transform_key=key, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del cold
    tcore.clear_device_tile_cache()
    for n in EXACT_WRAPPERS:
        getattr(tea, n).launches = 0
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    with GeneralTimer(torch, tcore) as gt:
        warm_kw = dict(kw)
        if timed_weights:
            warm_kw["weights_func"] = gt.weights(kw["weights_func"])
        t0 = time.perf_counter()
        fused = fuse(sims, transform_key=key, **warm_kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        warm_s = t1 - t0
        split = gt.split_ms(t0, t1)
        calls = dict(gt.calls)
    launches = {n: getattr(tea, n).launches for n in EXACT_WRAPPERS}
    launches.update(fuse_translation_2d=tf.fuse_translation_2d.launches,
                    fuse_translation_3d=tf.fuse_translation_3d.launches)
    out = fused.data
    covered = float(np.mean(out > 0))
    if out.dtype != sims[0].data.dtype or covered < 0.3 or (
        np.issubdtype(out.dtype, np.floating) and not np.isfinite(out).all()
    ):
        raise AssertionError(f"{label}: output {out.dtype}, covered {covered:.2f}, finite: "
                             f"{np.isfinite(out).all()}")
    start, size = window(out.shape) if callable(window) else window
    osp = {"origin": dict(fused.origin), "spacing": dict(fused.spacing),
           "shape": dict(zip(sdims, out.shape))}
    t0 = time.perf_counter()
    ref = fuse(cpu_sims or sims, transform_key=key, device="cpu",
               output_stack_properties=window_props(osp, sdims, start, size), **kw).data
    cpu_s = time.perf_counter() - t0
    got = out[tuple(slice(s, s + size) for s in start)]
    err = general_window_err(np, got, ref, label)
    n_out = int(np.prod(out.shape))
    say(f"{label}: output {out.shape} {out.dtype}, covered {covered:.2f}, cold fuse "
        f"{cold_s:.3f} s, warm fuse {warm_s:.3f} s ({n_out / warm_s / 1e6:.1f} Mvox/s)")
    say(f"{label}: warm split " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    say(f"{label}: tier units {json.dumps(calls)}, kernel launches "
        f"{json.dumps(launches)}; window "
        f"{tuple(start)} + {size} against device='cpu' ({cpu_s:.1f} s): max_abs_err {err:.3g}")
    return fused, {"cold_fuse_s": cold_s, "warm_fuse_s": warm_s, **split,
                   "calls": calls, "launches": launches, "window_max_abs_err": err,
                   "cpu_window_s": cpu_s, "out_shape": list(out.shape), "covered": covered}


def nan_affine_grid(np, tsi, tile, overlap, seed):
    """The affine 3D tile grid (4 x 4 tiles of ``tile``^3, couplings +-[0.005,
    0.02]) as float32, with NaN in each tile's outer ``tile // 32`` voxels and
    in one inner blob of ``3 * tile // 32`` voxels a side."""
    rng = np.random.default_rng(seed)

    def coupling(r):
        return np.eye(3) + r.uniform(0.005, 0.02, (3, 3)) * r.choice([-1, 1], (3, 3))

    sims = affine_grid_sims(np, tsi, 3, 4, tile, overlap, 5, coupling)
    edge, blob = tile // 32, 3 * tile // 32
    for sim in sims:
        data = sim.data.astype(np.float32)
        for axis in range(3):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[axis], hi[axis] = slice(0, edge), slice(tile - edge, tile)
            data[tuple(lo)] = np.nan
            data[tuple(hi)] = np.nan
        c = rng.integers(tile // 6, tile - tile // 4, 3)
        data[c[0]:c[0] + blob, c[1]:c[1] + blob, c[2]:c[2] + blob] = np.nan
        sim.data = data
    return sims


def general_small_cases(np, torch, tsi, tcore, tweights, fuse):
    """content_based_dct, a custom fusion function, interpolation_order=0 and
    trim_overlap=False at small sizes, each on the card against
    device="cpu"."""

    def custom(transformed_views, params, output_spacing, blending_weights, fusion_weights):
        w = torch.where(torch.isnan(transformed_views), 0.0, blending_weights * fusion_weights)
        total = w.sum(0)
        fused = (torch.nan_to_num(transformed_views) * w).sum(0)
        return fused / torch.where(total > 0, total, 1.0) + float(len(params))

    views = multiview_sims(np, tsi, (48, 64, 64), (0, 47, 92), seed=12)
    grid = grid_sims(np, tsi, 2, 4, 96, 24, seed=13)
    cases = [
        ("content_based_dct", views, dict(output_chunksize=32, weights_func=tweights.content_based_dct,
                                          weights_func_kwargs={"dct_size": 16})),
        ("custom fusion_func with fusion_weights", views,
         dict(output_chunksize=32, fusion_func=custom, weights_func=tweights.content_based,
              weights_func_kwargs={"sigma_1": 2, "sigma_2": 4})),
        ("interpolation_order=0", views, dict(output_chunksize=32, interpolation_order=0)),
        ("trim_overlap=False, max_fusion", grid,
         dict(output_chunksize=64, overlap_in_pixels=8, trim_overlap=False,
              fusion_func=tcore.max_fusion)),
        ("trim_overlap=False, content_based", grid,
         dict(output_chunksize=64, trim_overlap=False, weights_func=tweights.content_based,
              weights_func_kwargs={"sigma_1": 2, "sigma_2": 4})),
    ]
    errs = {}
    for label, sims, kw in cases:
        got = fuse(sims, transform_key=KEY, **kw)
        ref = fuse(sims, transform_key=KEY, device="cpu", **kw)
        if got.origin != ref.origin:
            raise AssertionError(f"general small case {label}: origin {got.origin} != {ref.origin}")
        errs[label] = general_window_err(np, got.data, ref.data, f"small case {label}")
        log(f"general: small case {label}: output {got.data.shape} {got.data.dtype}, "
            f"max_abs_err against device='cpu' {errs[label]:.3g}")
    return errs


def general_phase(np, torch, tsi, tcore, tweights, tea, tf, fuse, scale=1):
    """The general fusion path (phase 8): content-based fusion of the rotated
    multi-view path through the host tier; max_fusion of the 2D slide scan
    through the tiles tier; the affine 3D tile grid as float32 with NaN
    through the gather route; small cases. Each full-size case runs cold and
    warm on the card, and a chunk-aligned window is held to device="cpu".
    ``scale`` divides every size (a rehearsal on the CPU)."""
    out = {}
    c3 = 128 // scale
    sims = multiview_sims(np, tsi, tuple(n // scale for n in (256, 512, 512)), (0, 47, 92, 137),
                          seed=4)
    fused, out["content_based"] = general_case(
        np, torch, tcore, tea, tf, fuse, "3d multi-view, content-based", sims,
        dict(output_chunksize=c3, weights_func=tweights.content_based),
        window=((2 * c3,) * 3, c3), timed_weights=True,
    )
    if out["content_based"]["calls"].get("_fuse_views", 0) < 50 or any(
        out["content_based"]["launches"].values()
    ):
        raise AssertionError("general: the multi-view case did not run the host tier alone")
    del sims, fused
    torch.cuda.empty_cache()

    tile, c2 = 512 // scale, 1024 // scale
    sims = grid_sims(np, tsi, 2, n=32, tile=tile, overlap=64 // scale, seed=2)
    corner = [s for s in sims if s.origin["y"] < 2 * c2 and s.origin["x"] < 2 * c2]
    fused, out["max_tiles"] = general_case(
        np, torch, tcore, tea, tf, fuse, "2d slide scan, max_fusion", sims,
        dict(output_chunksize=c2, fusion_func=tcore.max_fusion),
        window=((0, 0), 2 * c2), cpu_sims=corner,
    )
    top = max(int(s.data.max()) for s in sims)
    if (not out["max_tiles"]["calls"].get("_resample_tiles") or int(fused.data.max()) > top
            or any(out["max_tiles"]["launches"].values())):
        raise AssertionError("general: the slide scan's max_fusion did not run the tiles tier alone")
    del sims, corner, fused
    torch.cuda.empty_cache()

    sims = nan_affine_grid(np, tsi, 256 // scale, 32 // scale, seed=7)
    fused, out["nan_gather"] = general_case(
        np, torch, tcore, tea, tf, fuse, "3d affine grid, float32 with NaN", sims,
        dict(output_chunksize=c3), window=((c3, 2 * c3, 2 * c3), c3),
    )
    if not out["nan_gather"]["calls"].get("_fuse_chunk_batch_kernel_gather") or any(
        out["nan_gather"]["launches"].values()
    ):
        raise AssertionError("general: the NaN grid did not take the gather route alone")
    del sims, fused
    torch.cuda.empty_cache()
    out["small_max_abs_err"] = general_small_cases(np, torch, tsi, tcore, tweights, fuse)
    return out


# the multiscale phase's drift of each tile at each timepoint, in px (z, y, x)
MS_DRIFT = (1, 3, 3)
# resolved offsets against the truth, after removing the global offset: at
# level 0 within MS_LEVEL0_ATOL px, at a coarser level within one of its
# pixels (its factor in level-0 px, per dim)
MS_LEVEL0_ATOL = 0.25
# the card's register(reg_res_level=2) against the CPU's, per timepoint, px
MS_CPU_ATOL = 1e-3


def smooth_noise(torch, shape, seed, device):
    """White noise from a torch generator seeded with ``seed`` under a
    1.5 px gaussian (radius 6, reflected at the edges) along every axis of
    13 or more, scaled to [0, 1000] as uint16 numpy; made on ``device``."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vol = torch.rand(shape, generator=gen, device=device)
    x = torch.arange(-6, 7, device=device, dtype=torch.float32)
    kernel = torch.exp(-x * x / (2 * 1.5 ** 2))
    kernel = (kernel / kernel.sum()).reshape(1, 1, -1)
    for axis in range(len(shape)):
        if shape[axis] < 13:
            continue
        v = vol.movedim(axis, -1)
        lead = v.shape
        v = F.conv1d(F.pad(v.reshape(-1, 1, lead[-1]), (6, 6), mode="reflect"), kernel)
        vol = v.reshape(lead).movedim(-1, axis)
    vol = (vol - vol.min()) * (1000.0 / (vol.max() - vol.min()))
    return vol.to(torch.int32).to(torch.uint16).cpu().numpy()


def multiscale_grid_sims(np, torch, tsi, n, nt, tile, overlap, seed, device):
    """n x n tiles of ``tile`` (z, y, x) uint16 over ``nt`` timepoints, cut
    from one band-limited volume (:func:`smooth_noise`): each tile's true
    position at each t is its grid position (step ``tile - overlap`` in y and
    x) plus an integer drift in [-1, 1] (z) and [-3, 3] (y, x). The metadata
    holds the grid positions, without t. Returns the sims (dims t, z, y, x),
    the true positions (n*n, nt, 3) and the grid positions (n*n, 3)."""
    rng = np.random.default_rng(seed)
    step = tile[1] - overlap
    margin = np.array(MS_DRIFT)
    shape = (tile[0] + 2 * margin[0],) + tuple(
        (n - 1) * step + tile[k] + 2 * margin[k] for k in (1, 2)
    )
    vol = smooth_noise(torch, shape, seed, device)
    sims, truth, grid = [], [], []
    for iy in range(n):
        for ix in range(n):
            g = np.array([0.0, iy * step, ix * step])
            drift = rng.integers(-margin, margin + 1, (nt, 3))
            data = np.empty((nt,) + tuple(tile), np.uint16)
            for t in range(nt):
                lo = (g + drift[t] + margin).astype(int)
                data[t] = vol[tuple(slice(lo[k], lo[k] + tile[k]) for k in range(3))]
            sims.append(tsi.get_sim_from_array(data, dims=["t", "z", "y", "x"],
                                               translation=dict(zip("zyx", g))))
            truth.append(g + drift)
            grid.append(g)
    return sims, np.array(truth), np.array(grid)


def quickstart_2d(np, torch, tsi, tcore, tf, fuse, say, device, n=2, tile=1024, overlap=128):
    """The README's Quickstart as written, in 2D: n x n (c, y, x) uint16
    tiles of two channels, spacing 0.5, cut from one band-limited image at
    their grid positions plus an integer drift in [-3, 3] px; the default
    pyramids, register() by channel 0 (the default resolution), fuse() of
    the msims, every (level, channel) plan launching ``fuse_translation_2d``
    (counted from 0 just before), a 512^2 window of level 0 against
    device="cpu"."""
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import param_utils as tpu
    from multiview_stitcher_torch import registration as treg

    rng = np.random.default_rng(13)
    step, margin = tile - overlap, 3
    extent = (n - 1) * step + tile + 2 * margin
    image = smooth_noise(torch, (2, extent, extent), 13, device)
    sims, truth, grid = [], [], []
    for iy in range(n):
        for ix in range(n):
            g = np.array([iy * step, ix * step], float)
            lo = (g + rng.integers(-margin, margin + 1, 2) + margin).astype(int)
            sims.append(tsi.get_sim_from_array(
                np.ascontiguousarray(image[:, lo[0]:lo[0] + tile, lo[1]:lo[1] + tile]),
                dims=("c", "y", "x"), scale={"y": 0.5, "x": 0.5},
                translation={"y": 0.5 * g[0], "x": 0.5 * g[1]}, c_coords=["a", "b"],
            ))
            truth.append((lo - margin) * 0.5)
            grid.append(g * 0.5)
    truth, grid = np.array(truth), np.array(grid)
    t0 = time.perf_counter()
    msims = [tmsi.get_msim_from_sim(s) for s in sims]
    params = treg.register(msims, transform_key=KEY, new_transform_key="registered",
                           reg_channel_index=0)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    reg = np.array([tpu.transform_pts(grid[k][None], np.asarray(p.data))[0]
                    for k, p in enumerate(params)])
    err = reg - truth
    off_err = float(np.abs(err - err.mean(axis=0)).max()) / 0.5
    if off_err > MS_LEVEL0_ATOL:
        raise AssertionError(f"quickstart 2d: offsets {off_err:.3f} px from the truth")
    plans = []
    execute = tcore._execute_fusion_plan

    def counted_plan(*a, **k):
        before = tf.fuse_translation_2d.launches
        execute(*a, **k)
        plans.append(tf.fuse_translation_2d.launches - before)

    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    tcore._execute_fusion_plan = counted_plan
    try:
        t0 = time.perf_counter()
        fused = fuse(msims, transform_key="registered")
        torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
    finally:
        tcore._execute_fusion_plan = execute
    launches = tf.fuse_translation_2d.launches
    n_levels = len(tmsi.calc_resolution_levels(tsi.get_shape_from_sim(fused.sims[0]))[0])
    if (len(fused.sims) != n_levels or len(plans) != 2 * n_levels or min(plans) < 1
            or tf.fuse_translation_3d.launches):
        raise AssertionError(f"quickstart 2d: {len(fused.sims)} levels, fuse_translation_2d "
                             f"launches per (level, c) {plans}")
    lvl = fused.sims[0]
    win = 512
    start = [(lvl.sizes[d] // 2 // win) * win for d in ("y", "x")]
    inputs = [tmsi.get_sim_from_msim(tmsi.multiscale_sel_coords(m, {"c": "b"})) for m in msims]
    ref = fuse(inputs, transform_key="registered", device="cpu",
               output_stack_properties=window_props(
                   {"spacing": lvl.spacing, "origin": lvl.origin}, ["y", "x"], start, win)).data
    got = lvl.data[1][tuple(slice(s0, s0 + win) for s0 in start)]
    win_err = max_err(got, ref, np) if got.shape == ref.shape else float("inf")
    if win_err > UINT_COUNTS:
        raise AssertionError(f"quickstart 2d: level 0's window differs from the CPU's by "
                             f"{win_err:g}")
    say(f"the README's Quickstart in 2D: {n} x {n} (c, y, x) tiles of (2, {tile}, {tile}) "
        f"uint16, overlap {overlap}; pyramids and register(reg_channel_index=0) in "
        f"{reg_s:.3f} s, offsets within {off_err:.4f} px of the truth; fuse(msims) in "
        f"{fuse_s:.3f} s: {len(fused.sims)} levels {[tuple(x.data.shape) for x in fused.sims]}, "
        f"fuse_translation_2d launches {launches}, per (level, c) {plans}; a {win}^2 window of "
        f"level 0 within {win_err:g} counts of device='cpu'")
    return {"register_s": reg_s, "offset_max_err_px": off_err, "fuse_s": fuse_s,
            "launches": launches, "launches_per_level_c": plans, "window_err": win_err}


def multiscale_phase(np, torch, tsi, tcore, tf, fuse, work, n=3, nt=3, tile=(128, 512, 512),
                     overlap=64):
    """The multiscale phase: a light-sheet time-lapse tile grid through the
    README's pattern on the card: the default pyramid of each view,
    register() at three levels over t, fuse() of the msims into a pyramid, an
    OME-Zarr leg at t = 0 and one stitch() of the time-lapse; every time
    printed beside the card. The 3D grid's content is made on the card when
    there is one (the CPU rehearses it)."""
    import shutil

    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import param_utils as tpu
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch import stitch as tstitch
    from multiview_stitcher_torch.io import ngff_utils as tngff
    from multiview_stitcher_torch.io import zarr_backend as tzb

    label = "multiscale"
    card = card_line()
    t_phase = time.perf_counter()
    out = {}

    def say(msg):
        log(f"{label}: {msg} [{card}]")

    t0 = time.perf_counter()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    sims, truth, grid = multiscale_grid_sims(np, torch, tsi, n, nt, tile, overlap, seed=12,
                                             device=device)
    out["grid_make_s"] = time.perf_counter() - t0
    tile_bytes = sum(s.data.nbytes for s in sims)

    # 1. the default pyramid of each view
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sims)) as ex:
        msims = list(ex.map(tmsi.get_msim_from_sim, sims))
    out["pyramid_s"] = time.perf_counter() - t0
    shapes = [tuple(s.data.shape) for s in msims[0].sims]
    if len(shapes) != 3:
        raise AssertionError(f"{label}: the default pyramid has levels {shapes}, 3 expected")
    say(f"{n} x {n} tiles of {tile} uint16 over {nt} timepoints, overlap {overlap}, drift within "
        f"{MS_DRIFT} px, {tile_bytes} bytes of tiles (made in {out['grid_make_s']:.1f} s); "
        f"get_msim_from_sim of the {len(sims)} views on the host in {out['pyramid_s']:.3f} s: "
        f"levels {shapes}")

    # 2. register at three levels over t; offsets resolved by shortest paths
    def offsets_error(params, factor):
        worst = np.zeros(3)
        for it in range(nt):
            reg = np.array([tpu.transform_pts(grid[k][None], np.asarray(p.data[it]))[0]
                            for k, p in enumerate(params)])
            err = reg - truth[:, it]
            worst = np.maximum(worst, np.abs(err - err.mean(axis=0)).max(axis=0))
        if any(p.data.shape[0] != nt for p in params):
            raise AssertionError(f"{label}: params over {params[0].data.shape[0]} timepoints")
        return worst, bool(np.all(worst <= factor))

    regs = {}
    for name, kw, level, factor in (
        ("default", {}, "scale0", np.full(3, MS_LEVEL0_ATOL)),
        ("binning 1/2/2", {"registration_binning": {"z": 1, "y": 2, "x": 2}}, "scale1",
         np.array([1.0, 2.0, 2.0])),
        ("reg_res_level=2", {"reg_res_level": 2}, "scale2", np.array([1.0, 4.0, 4.0])),
    ):
        t0 = time.perf_counter()
        params = treg.register(msims, transform_key=KEY,
                               groupwise_resolution_method="shortest_paths",
                               new_transform_key="registered" if name == "default" else None,
                               **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tel = dict(treg.last_telemetry)
        if tel["levels"] != [level]:
            raise AssertionError(f"{label}: register({name}) ran at {tel['levels']}, not {level}")
        worst, ok = offsets_error(params, factor)
        if not ok:
            raise AssertionError(f"{label}: register({name}) offsets {worst.tolist()} px from the "
                                 f"truth, allowed {factor.tolist()}")
        regs[name] = params
        out[f"register_{level}"] = {"s": wall, "pairs": tel["pairs"], "units": tel["units"],
                                    "buckets": tel["buckets"], "batches": tel["batches"],
                                    "crop_upload_bytes": tel["crop_upload_bytes"],
                                    "pairwise_device_ms": tel.get("pairwise_device_ms"),
                                    "offset_max_err_px": worst.tolist()}
        say(f"register({name}): level {level}, {tel['pairs']} pairs x {nt} timepoints = "
            f"{tel['units']} units in {tel['buckets']} buckets, {tel['batches']} batches, crops "
            f"uploaded {tel['crop_upload_bytes']} bytes, {wall:.3f} s (pairwise on the card "
            f"{tel.get('pairwise_device_ms', float('nan')):.1f} ms); offsets per t within "
            f"{np.round(worst, 4).tolist()} px (z, y, x) of the truth (allowed {factor.tolist()})")
    # the card's level-2 registration against the CPU's, on the first row's
    # first pair over every timepoint (the CPU's candidate scoring is slow)
    pair = [msims[0], msims[1]]
    t0 = time.perf_counter()
    host = treg.register(pair, transform_key=KEY, reg_res_level=2, device="cpu")
    cpu_s = time.perf_counter() - t0
    card_pair = treg.register(pair, transform_key=KEY, reg_res_level=2)
    cpu_err = max(float(np.abs(np.asarray(a.data) - np.asarray(b.data)).max())
                  for a, b in zip(card_pair, host))
    if cpu_err > MS_CPU_ATOL:
        raise AssertionError(f"{label}: the card's register(reg_res_level=2) differs from the "
                             f"CPU's by {cpu_err:g} px")
    out["cpu_pair_err_px"], out["cpu_pair_s"] = cpu_err, cpu_s
    say(f"register(reg_res_level=2) of one pair over {nt} timepoints: card within {cpu_err:g} px "
        f"of device='cpu' per t (CPU {cpu_s:.2f} s)")

    # 3. fuse the msims into a pyramid: each level's time and the
    # fuse_translation_3d launches of each (level, timepoint) plan
    plans, level_s = [], []
    execute, fuse_fn = tcore._execute_fusion_plan, tcore.fuse

    def counted_plan(*a, **k):
        before = tf.fuse_translation_3d.launches
        execute(*a, **k)
        plans.append(tf.fuse_translation_3d.launches - before)

    def timed_fuse(images, **k):
        t = time.perf_counter()
        res = fuse_fn(images, **k)
        torch.cuda.synchronize()
        level_s.append(time.perf_counter() - t)
        return res

    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    tcore._execute_fusion_plan, tcore.fuse = counted_plan, timed_fuse
    try:
        t0 = time.perf_counter()
        fused = fuse(msims, transform_key="registered")
        torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
    finally:
        tcore._execute_fusion_plan, tcore.fuse = execute, fuse_fn
    launches = tf.fuse_translation_3d.launches
    # the output pyramid is the plan of the output's own shape
    n_levels = len(tmsi.calc_resolution_levels(
        tsi.get_shape_from_sim(fused.sims[0]) if tmsi.is_msim(fused) else {})[0])
    if not tmsi.is_msim(fused) or len(fused.sims) != n_levels or any(
            s.sizes["t"] != nt for s in fused.sims):
        raise AssertionError(f"{label}: fuse() gave {type(fused).__name__} of "
                             f"{[s.data.shape for s in getattr(fused, 'sims', [])]}")
    if len(plans) != n_levels * nt or min(plans) < 1 or tf.fuse_translation_2d.launches:
        raise AssertionError(f"{label}: fuse_translation_3d launches per (level, t) {plans}")
    # a window of levels 0 and 1 at the last t against device="cpu"
    t_last = fused.sims[0].coords["t"][-1]
    win_err = 0.0
    win = min(128, tile[0])
    for level in (0, 1):
        lvl = fused.sims[level]
        osp = {"spacing": lvl.spacing, "origin": lvl.origin}
        start = [0] + [(lvl.sizes[d] // 2 // win) * win for d in ("y", "x")]
        inputs = [tmsi.get_sim_from_msim(tmsi.multiscale_sel_coords(m, {"t": t_last}),
                                         scale=tmsi.get_res_level_from_spacing(m, lvl.spacing))
                  for m in msims]
        ref = fuse(inputs, transform_key="registered", device="cpu",
                   output_stack_properties=window_props(osp, ["z", "y", "x"], start, win)).data
        got = lvl.data[-1][tuple(slice(s, s + win) for s in start)]
        err = max_err(got, ref, np) if got.shape == ref.shape else float("inf")
        if err > UINT_COUNTS:
            raise AssertionError(f"{label}: level {level}'s window differs from the CPU's by "
                                 f"{err:g} ({got.shape} / {ref.shape})")
        win_err = max(win_err, err)
    out.update(fuse_s=fuse_s, fuse_level_s=level_s, fuse_launches=launches,
               fuse_launches_per_level_t=plans, fuse_window_err=win_err)
    say(f"fuse(msims): {len(fused.sims)} levels "
        f"{[tuple(s.data.shape) for s in fused.sims]} uint16 in {fuse_s:.3f} s, per level "
        f"{[round(x, 3) for x in level_s]} s; fuse_translation_3d launches {launches}, per "
        f"(level, t) {plans}; {win}^3 windows of levels 0 and 1 at t = {t_last} within "
        f"{win_err:g} counts of device='cpu'")

    # 4. the OME-Zarr leg at t = 0
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0_coord = fused.sims[0].coords["t"][0]
        at0 = [tmsi.multiscale_sel_coords(m, {"t": t0_coord}) for m in msims]
        urls = [str(work / f"tile{k}.ome.zarr") for k in range(len(at0))]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(at0)) as ex:
            list(ex.map(lambda a: tngff.write_msim_to_ome_zarr(*a, overwrite=True),
                        zip(at0, urls)))
        write_s = time.perf_counter() - t0
        zmsims = [tngff.read_msim_from_ome_zarr(u) for u in urls]
        # which arrays the registration reads
        read_paths = set()
        zread = tzb.ZarrV2.read

        def spy(self, box):
            read_paths.add(os.path.basename(self.path))
            return zread(self, box)

        tzb.ZarrV2.read = spy
        try:
            t0 = time.perf_counter()
            zparams = treg.register(zmsims, transform_key=KEY,
                                    groupwise_resolution_method="shortest_paths",
                                    registration_binning={"z": 1, "y": 2, "x": 2})
            torch.cuda.synchronize()
            zreg_s = time.perf_counter() - t0
        finally:
            tzb.ZarrV2.read = zread
        zlevels = treg.last_telemetry["levels"]
        if zlevels != ["scale1"] or read_paths != {"1"}:
            raise AssertionError(f"{label}: the OME-Zarr registration ran at {zlevels} and read "
                                 f"arrays {sorted(read_paths)}")
        zreg_err = max(float(np.abs(np.asarray(z.data) - np.asarray(m.data[0])).max())
                       for z, m in zip(zparams, regs["binning 1/2/2"]))
        if zreg_err > MS_CPU_ATOL:
            raise AssertionError(f"{label}: the OME-Zarr registration differs from the in-memory "
                                 f"one at t = 0 by {zreg_err:g} px")
        t0 = time.perf_counter()
        zfused = fuse(zmsims, transform_key="registered", output_zarr_url=str(work / "fused.zarr"),
                      zarr_options={"ome_zarr": True})
        zfuse_s = time.perf_counter() - t0
        if not tmsi.is_msim(zfused) or len(zfused.sims) != n_levels:
            raise AssertionError(f"{label}: the OME-Zarr fuse returned {type(zfused).__name__}")
        z0 = zfused.sims[0].to_numpy()
        if z0.shape != fused.sims[0].data.shape[1:] or not np.array_equal(
                z0, fused.sims[0].data[0]):
            raise AssertionError(f"{label}: the OME-Zarr level 0 differs from the in-memory t = 0")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update(zarr_write_s=write_s, zarr_register_s=zreg_s, zarr_fuse_s=zfuse_s,
               zarr_register_err_px=zreg_err)
    say(f"OME-Zarr at t = 0: {len(urls)} msims written in {write_s:.3f} s, reopened lazily; "
        f"register(binning 1/2/2) at {zlevels[0]} reading arrays {sorted(read_paths)} only in "
        f"{zreg_s:.3f} s, within {zreg_err:g} px of the in-memory one; fuse to OME-Zarr in "
        f"{zfuse_s:.3f} s: an msim of {len(zfused.sims)} levels, level 0 equal to the in-memory "
        f"t = 0 bit for bit; store removed")

    # 5. one stitch() of the time-lapse
    t0 = time.perf_counter()
    stitched = tstitch.stitch(msims)
    torch.cuda.synchronize()
    stitch_s = time.perf_counter() - t0
    st_err = (max_err(stitched.data, fused.sims[0].data, np)
              if stitched.data.shape == fused.sims[0].data.shape else float("inf"))
    if st_err > UINT_COUNTS:
        raise AssertionError(f"{label}: stitch() differs from fuse()'s level 0 by {st_err:g}")
    out.update(stitch_s=stitch_s, stitch_err=st_err)
    del fused, stitched, msims, sims
    say(f"stitch(msims) over t in {stitch_s:.3f} s ({treg.last_telemetry['units']} units), level "
        f"0 within {st_err:g} counts of fuse()")

    # 6. the README's Quickstart as written, in 2D
    out["quickstart_2d"] = quickstart_2d(np, torch, tsi, tcore, tf, fuse, say, device)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {out['phase_s']:.1f} s")
    return out


# the stitch phase's grid: overlap tolerance (physical units, spacing 1) that
# covers the metadata's error, so that every pair's crops hold their common
# content
# ---------------------------------------------------------------------------
# the beads phase: bead-based multi-view registration
# ---------------------------------------------------------------------------

BEADS_ANGLES = (0, 47, 92, 137)
BEADS_SIGMA = 1.2
# a true bead counts as found where a detection lies within this many px of
# it, for the beads at least BEADS_INSIDE px inside. The detections are the
# voxels of LoG maxima (a label's centroid is its voxel), so a found bead
# lies up to half a voxel off along each axis: sqrt(3) / 2 px. The share
# within 0.5 px along every axis (the bead's nearest voxel; noise moves a
# bead halfway between two voxels to the other one) is printed beside it
BEADS_MATCH_PX = float(3 ** 0.5 / 2)
BEADS_INSIDE = 4
BEADS_RECALL = 0.98
# one view's detection on the card against device="cpu": bead count and
# matched centroids
BEADS_COUNT_REL = 0.002
BEADS_CPU_ATOL = 1e-3
# each resolved view's true beads in the world against view 0's, px
BEADS_RMS = 0.25
BEADS_MAX = 0.5
# pairwise shifts of the step-by-step phase correlation against the default
BEADS_SHIFT_ATOL = 1e-3
BEADS_REG_KW = {"transform_type": "rigid", "ransac_max_error": 2.0, "icp": True}


def bead_positions(np, rng, shape, n, margin=12, min_dist=6.0):
    """``n`` bead centres in the box ``shape``, at least ``margin`` px
    inside and ``min_dist`` px apart: candidates drawn uniformly and kept
    when no kept centre lies within ``min_dist`` (a hash of cells of that
    size)."""
    import itertools

    lo = np.full(3, float(margin))
    hi = np.asarray(shape, dtype=float) - 1 - margin
    cells, out = {}, []
    offsets = list(itertools.product((-1, 0, 1), repeat=3))
    while len(out) < n:
        for p in rng.uniform(lo, hi, (4096, 3)):
            key = tuple(int(v) for v in p // min_dist)
            near = (q for dk in offsets
                    for q in cells.get((key[0] + dk[0], key[1] + dk[1], key[2] + dk[2]), ()))
            if any(float(np.sum((p - q) ** 2)) < min_dist * min_dist for q in near):
                continue
            cells.setdefault(key, []).append(p)
            out.append(p)
            if len(out) == n:
                break
    return np.array(out)


def render_bead_view(np, torch, tfilters, beads, amps, view_affine, shape, seed, device):
    """One view's uint16 image: the beads (world positions) placed in the
    view's pixel grid through the inverse of its true affine, splatted
    trilinearly with masses that give each bead's amplitude as the peak of a
    centred blob, blurred by ``gaussian_filter`` (sigma BEADS_SIGMA) through
    the port, on a background of 100 with gaussian noise of sigma 10 (a torch
    generator seeded with ``seed``); made on ``device``."""
    import itertools

    k1 = tfilters.gaussian_kernel_1d(BEADS_SIGMA)
    mass = 1.0 / float(k1.max()) ** 3
    q = (beads - view_affine[:3, 3]) @ np.linalg.inv(view_affine[:3, :3]).T
    keep = np.all((q >= -4) & (q <= np.asarray(shape) + 3), axis=1)
    q, a = q[keep], amps[keep] * mass
    base = np.floor(q).astype(np.int64)
    frac = q - base
    vol = torch.zeros(shape, dtype=torch.float32, device=device)
    for corner in itertools.product((0, 1), repeat=3):
        idx = base + np.asarray(corner)
        w = np.prod(np.where(np.asarray(corner, bool), frac, 1 - frac), axis=1) * a
        ok = np.all((idx >= 0) & (idx < np.asarray(shape)), axis=1)
        index = tuple(torch.from_numpy(idx[ok, d]).to(device) for d in range(3))
        vol.index_put_(index, torch.from_numpy(w[ok].astype(np.float32)).to(device),
                       accumulate=True)
    vol = tfilters.gaussian_filter(vol, BEADS_SIGMA)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vol += torch.randn(shape, generator=gen, device=device) * 10.0 + 100.0
    vol = vol.round_().clamp_(0, 65535).to(torch.int32).to(torch.uint16)
    return vol.cpu().numpy()


def rigid_error(np, rng, centre, deg_range=(1.0, 2.0), shift_range=(2.0, 5.0)):
    """A rigid map through ``centre``: a rotation by an angle in
    ``deg_range`` about a random axis, then a shift of a length in
    ``shift_range`` in a random direction."""
    from scipy.spatial.transform import Rotation

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    rot = Rotation.from_rotvec(axis * np.deg2rad(rng.uniform(*deg_range))).as_matrix()
    direction = rng.normal(size=3)
    shift = direction / np.linalg.norm(direction) * rng.uniform(*shift_range)
    m = about_centre(np, rot, centre)
    m[:3, 3] += shift
    return m


def bead_recall(np, truth_px, found_px, shape):
    """The share of the true beads at least BEADS_INSIDE px inside the view
    with a detection within BEADS_MATCH_PX px, the share with one within
    0.5 px along every axis, their count, and the median distance to the
    nearest detection."""
    from scipy.spatial import cKDTree

    inside = np.all((truth_px >= BEADS_INSIDE)
                    & (truth_px <= np.asarray(shape) - 1 - BEADS_INSIDE), axis=1)
    if not len(found_px):
        return 0.0, 0.0, int(inside.sum()), float("inf")
    tree = cKDTree(found_px)
    d_2, _ = tree.query(truth_px[inside])
    d_inf, _ = tree.query(truth_px[inside], p=np.inf)
    return (float(np.mean(d_2 <= BEADS_MATCH_PX)), float(np.mean(d_inf <= 0.5)),
            int(inside.sum()), float(np.median(d_2)))


def edge_inliers(np, tpu, edge_mat, fixed_world, moving_world, max_error):
    """Fixed points whose nearest moving point lies within ``max_error`` of
    them under an edge's transform (the inliers of the final fit)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(moving_world).query(tpu.transform_pts(fixed_world, edge_mat))
    return int(np.sum(d <= max_error))


def beads_phase(np, torch, tsi, tcore, tea, tf, fuse, shape=(256, 512, 512), n_beads=3000,
                small_tile=64):
    """The beads phase: a multi-view light-sheet acquisition with fiducial
    beads, four views of ``shape`` uint16 rotated about y by BEADS_ANGLES
    about the centre, rendered on the card from ``n_beads`` beads; views
    1-3's metadata off by a rigid error of 1-2 degrees and 2-5 px. Bead
    detection on the card (and one view on the CPU), marker registration of
    the 6 pairs resolved by global optimisation and by the linear two-pass
    method, fuse() of the registered views through the exact-affine kernels,
    and the small cases of the per-pair path: the step-by-step phase
    correlation and a thread-pool executor on a 2 x 2 grid."""
    from multiview_stitcher_torch import detection as tdet
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import param_utils as tpu
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch.ops import filters as tfilters

    label = "beads"
    card = card_line()
    t_phase = time.perf_counter()
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = {}

    def say(msg):
        log(f"{label}: {msg} [{card}]")

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    # the data: one bead volume seen by four views, rendered on the card
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    beads = bead_positions(np, rng, shape, n_beads)
    amps = 2000.0 * rng.uniform(0.8, 1.2, len(beads))
    centre = [(n - 1) / 2 for n in shape]
    true_affines = [about_centre(np, roty(np, np.deg2rad(a)), centre) for a in BEADS_ANGLES]
    errors = [np.eye(4)] + [rigid_error(np, rng, centre) for _ in BEADS_ANGLES[1:]]
    views, msims = [], []
    for iv, (a_true, err) in enumerate(zip(true_affines, errors)):
        data = render_bead_view(np, torch, tfilters, beads, amps, a_true, shape, 100 + iv, device)
        sim = tsi.get_sim_from_array(data, dims=["z", "y", "x"])
        tsi.set_sim_affine(sim, err @ a_true, transform_key=KEY)
        views.append(data)
        msims.append(tmsi.get_msim_from_sim(sim, scale_factors=[]))
    out["make_s"] = synced() - t0
    truth_px = [tpu.transform_pts(beads, np.linalg.inv(a)) for a in true_affines]
    say(f"{len(BEADS_ANGLES)} views of {shape} uint16 ({sum(v.nbytes for v in views)} bytes) "
        f"rotated about y by {BEADS_ANGLES} deg, {len(beads)} beads (sigma {BEADS_SIGMA} px, "
        f"amplitude 2000 +- 20 %, background 100, noise sigma 10), rendered on the card in "
        f"{out['make_s']:.1f} s; metadata errors of views 1-3: "
        + ", ".join(
            f"{np.rad2deg(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))):.2f} deg / "
            f"{np.linalg.norm(e[:3, 3] - (centre - e[:3, :3] @ centre)):.2f} px"
            for e in errors[1:]
        ))

    # 1. detection on the card, each view's points set on its msim
    det_kw = {"target_size_physical": 3.0}
    found, det = [], []
    for iv, m in enumerate(msims):
        t0 = time.perf_counter()
        pts = tdet.detect_beads(m, detection_func_kwargs=det_kw, device=device)
        wall = time.perf_counter() - t0
        tmsi.set_point_set(m, pts)
        recall, nearest, n_inside, med = bead_recall(np, truth_px[iv], pts, shape)
        tel = dict(tdet.last_telemetry)
        det.append({"found": len(pts), "recall": recall, "nearest_voxel_share": nearest,
                    "beads_inside": n_inside, "median_px": med, "wall_s": wall, **tel})
        found.append(pts)
        say(f"detect_beads view {iv}: {len(pts)} beads found, recall {recall:.4f} of "
            f"{n_inside} beads {BEADS_INSIDE} px inside (within {BEADS_MATCH_PX:.3f} px; "
            f"{nearest:.4f} within 0.5 px per axis; median distance {med:.3f} px), "
            f"{wall:.2f} s: {tel['windows']} windows, upload "
            f"{tel['upload_s']:.3f} s, filters on the card {tel['filters_s']:.3f} s, mask "
            f"download {tel['download_s']:.3f} s, labelling {tel['label_s']:.3f} s")
        if recall < BEADS_RECALL:
            raise AssertionError(f"{label}: view {iv} recall {recall:.4f} < {BEADS_RECALL}")
    out["detect"] = det

    # 2. one view again on the CPU
    t0 = time.perf_counter()
    cpu_pts = tdet.detect_beads(msims[1], detection_func_kwargs=det_kw, device="cpu")
    cpu_s = time.perf_counter() - t0
    from scipy.spatial import cKDTree

    d, _ = cKDTree(cpu_pts).query(found[1]) if len(cpu_pts) else (np.array([np.inf]), None)
    matched = d <= BEADS_MATCH_PX
    count_rel = abs(len(cpu_pts) - len(found[1])) / max(len(cpu_pts), 1)
    cpu_err = float(d[matched].max(initial=0.0))
    out["cpu_check"] = {"cpu_found": len(cpu_pts), "count_rel": count_rel,
                        "matched": int(matched.sum()), "max_px": cpu_err, "cpu_s": cpu_s}
    say(f"view 1 on the CPU: {len(cpu_pts)} beads against {len(found[1])} on the card "
        f"({count_rel:.2%}), {int(matched.sum())} matched within {cpu_err:.2e} px, {cpu_s:.1f} s")
    if count_rel > BEADS_COUNT_REL or cpu_err > BEADS_CPU_ATOL:
        raise AssertionError(f"{label}: card and CPU detections differ: {out['cpu_check']}")

    # 3-4. marker registration of the 6 pairs, two resolutions
    def view_errors(key):
        """Each view's true beads (inside it) in the world under its
        resolved transform, against view 0's transform of the same beads:
        (rms, max) per view."""
        f0 = np.asarray(msims[0].transforms[key].data)
        res = []
        for iv, m in enumerate(msims):
            inside = np.all((truth_px[iv] >= 0) & (truth_px[iv] <= np.asarray(shape) - 1), axis=1)
            fi = np.asarray(m.transforms[key].data)
            e = np.linalg.norm(tpu.transform_pts(truth_px[iv][inside], fi)
                               - tpu.transform_pts(truth_px[0][inside], f0), axis=1)
            res.append((float(np.sqrt(np.mean(e ** 2))), float(e.max())))
        return res

    regs = {}
    for method in ("global_optimization", "linear_two_pass"):
        new_key = f"beads_{method}"
        t0 = time.perf_counter()
        rd = treg.register(
            msims, transform_key=KEY, new_transform_key=new_key,
            pairwise_reg_func=treg.registration_marker_based,
            pairwise_reg_func_kwargs=dict(BEADS_REG_KW), pre_registration_pruning_method=None,
            groupwise_resolution_method=method, groupwise_resolution_kwargs={"transform": "rigid"},
            return_dict=True, device=device,
        )
        reg_s = time.perf_counter() - t0
        g = rd["pairwise_registration"]["graph"]
        pairs = {}
        for u, v, attrs in g.edges(data=True):
            fw = tpu.transform_pts(found[u], np.asarray(msims[u].transforms[KEY].data))
            mw = tpu.transform_pts(found[v], np.asarray(msims[v].transforms[KEY].data))
            pairs[f"{u}-{v}"] = {
                "quality": float(attrs["quality"]),
                "inliers": edge_inliers(np, tpu, np.asarray(attrs["transform"].data), fw, mw,
                                        BEADS_REG_KW["ransac_max_error"]),
            }
        errs = view_errors(new_key)
        regs[method] = {"register_s": reg_s, "pairs": pairs, "view_rms_max_px": errs,
                        "route": treg.last_telemetry.get("route")}
        say(f"register ({method}): {len(pairs)} pairs through the "
            f"{treg.last_telemetry.get('route')} path in {reg_s:.2f} s; pairs "
            + json.dumps({k: (round(p["quality"], 4), p["inliers"]) for k, p in pairs.items()})
            + " (quality, inliers within 2 px); views' error against view 0 (rms, max px) "
            + json.dumps([(round(a, 4), round(b, 4)) for a, b in errs]))
        if len(pairs) != 6 or any(a > BEADS_RMS or b > BEADS_MAX for a, b in errs):
            raise AssertionError(f"{label}: {method}: pairs {len(pairs)}, errors {errs}")
    out["register"] = regs

    # 5. fuse() of the registered views on the card, counts from 0 just before
    key = "beads_global_optimization"
    sims = [m.get_scale("scale0") for m in msims]
    tcore.clear_device_tile_cache()
    for n in EXACT_WRAPPERS:
        getattr(tea, n).launches = 0
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    tea.record_routes(device)
    t0 = time.perf_counter()
    fused = fuse(sims, transform_key=key, output_chunksize=128, device=device)
    fuse_s = synced() - t0
    routes = tea.read_routes()
    launches = {n: getattr(tea, n).launches for n in EXACT_WRAPPERS}
    launches.update(fuse_translation_2d=tf.fuse_translation_2d.launches,
                    fuse_translation_3d=tf.fuse_translation_3d.launches)
    fo = fused.data
    if fo.dtype != np.uint16 or fo.ndim != 3 or not any(launches[n] for n in EXACT_WRAPPERS):
        raise AssertionError(f"{label}: fuse output {fo.shape} {fo.dtype}, launches {launches}")
    sdims = ["z", "y", "x"]
    size = 128
    start = [max(0, ((n - size) // 2) // 128 * 128) for n in fo.shape]
    osp = {"origin": dict(fused.origin), "spacing": dict(fused.spacing),
           "shape": dict(zip(sdims, fo.shape))}
    t0 = time.perf_counter()
    ref = fuse(sims, transform_key=key, output_chunksize=128, device="cpu",
               output_stack_properties=window_props(osp, sdims, start, size)).data
    cpu_fuse_s = time.perf_counter() - t0
    got = fo[tuple(slice(s, s + size) for s in start)]
    window_err = general_window_err(np, got, ref, f"{label}: fuse window")
    out["fuse"] = {"fuse_s": fuse_s, "out_shape": list(fo.shape), "launches": launches,
                   "routes": routes, "window_start": start, "window_max_abs_err": window_err,
                   "cpu_window_s": cpu_fuse_s}
    say(f"fuse of the registered views: output {fo.shape} uint16 in {fuse_s:.2f} s, kernel "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}, routes "
        f"{json.dumps(routes)}; central window {tuple(start)} + {size}^3 against device='cpu' "
        f"({cpu_fuse_s:.1f} s): max_abs_err {window_err}")
    del fused, fo, got, ref

    # 6. small cases: the step-by-step phase correlation and an executor
    grid, _, _ = stitch_grid_sims(np, tsi, 2, small_tile, small_tile // 4, seed=23)
    grid_kw = dict(transform_key=KEY, overlap_tolerance={"z": 1.0, "y": 3.0, "x": 3.0},
                   return_dict=True, device=device)
    t0 = time.perf_counter()
    default = treg.register(grid, **grid_kw)
    t1 = time.perf_counter()
    stepwise = treg.register(grid, pairwise_reg_func_kwargs={"use_fused_core": False}, **grid_kw)
    t2 = time.perf_counter()
    if treg.last_telemetry.get("route") != "per_pair":
        raise AssertionError(f"{label}: use_fused_core=False took {treg.last_telemetry}")

    def pool_executor(ms, edges, kwargs):
        with ThreadPoolExecutor(max_workers=4) as ex:
            return list(ex.map(
                lambda e: treg.register_pair_of_msims(ms[e[0]], ms[e[1]], **kwargs), edges))

    executor = treg.register(grid, pairwise_executor=pool_executor, **grid_kw)
    t3 = time.perf_counter()
    g_d = default["pairwise_registration"]["graph"]
    shift_err = {}
    for name, rd in (("use_fused_core=False", stepwise), ("executor", executor)):
        g_o = rd["pairwise_registration"]["graph"]
        shift_err[name] = max(
            float(np.abs(np.asarray(g_o.edges[e]["transform"].data)[:3, 3]
                         - np.asarray(g_d.edges[e]["transform"].data)[:3, 3]).max())
            for e in g_d.edges
        )
    out["small"] = {"default_s": t1 - t0, "stepwise_s": t2 - t1, "executor_s": t3 - t2,
                    "pairs": g_d.number_of_edges(), "shift_max_px": shift_err}
    say(f"2 x 2 grid of {small_tile}^3: {g_d.number_of_edges()} pairs, register default "
        f"{t1 - t0:.2f} s, use_fused_core=False {t2 - t1:.2f} s, thread-pool executor "
        f"{t3 - t2:.2f} s; pair shifts against the default (px): {json.dumps(shift_err)}")
    if any(v > BEADS_SHIFT_ATOL for v in shift_err.values()):
        raise AssertionError(f"{label}: per-pair shifts differ from the default: {shift_err}")

    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {out['phase_s']:.1f} s")
    return out, sims


# the deconvolution phase: the views' Gaussian PSF (sigma in px; 9^3), RL
# iterations, output chunks, and the windows of its small cases
DECONV_SIGMA = 1.2
DECONV_ITERATIONS = 10
DECONV_CHUNK = 128
DECONV_SMALL = 64
# the Tikhonov case's tolerance against the CPU, in ulps of the reference's
# float32 square root (see deconv_phase), beside the usual 1 count
DECONV_TIKHONOV_FLIPS = 8


def central_window(shape, size):
    """The chunk-aligned window of ``size`` nearest the centre of ``shape``."""
    return [max(0, ((n - size) // 2) // size * size) for n in shape]


def deconv_phase(np, torch, tcore, tea, tf, fuse, sims, key, chunk=DECONV_CHUNK,
                 small=DECONV_SMALL):
    """The deconvolution phase: multi-view Richardson-Lucy deconvolution
    (Preibisch 2014, efficient Bayesian kernels) of the beads phase's four
    registered views, placed by ``key``, as fuse()'s ``fusion_func``
    through the host tier: a cold and a warm call, the warm one split by
    stage, the five kernels' launches counted from 0 just before it, a
    central chunk-aligned window held to device="cpu"; the beads sharper
    than the weighted-average fuse() of the same views; one chunk's RL timed
    alone with its convolutions' share, beside cuDNN's conv3d of the same
    convolution; small cases (INDEPENDENT kernels, alone and with Tikhonov
    regularisation; the sample boundary eroded by 2 px) held to
    device="cpu" on ``small``^3 windows."""
    import functools

    from multiview_stitcher_torch.fusion import mv_deconv as tdeconv
    from multiview_stitcher_torch.utils.misc import full_f32

    card = card_line()
    t_phase = time.perf_counter()
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = {}

    def say(msg):
        log(f"[{card}] deconv: {msg}")

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    psf = tdeconv.make_gaussian_psf(DECONV_SIGMA, ndim=3)
    fkw = {"n_iterations": DECONV_ITERATIONS}
    fullest = {}

    @functools.wraps(tdeconv.multi_view_deconvolution)
    def deconvolve(**k):
        """The fusion function with the views' PSF, one for each view that
        reaches the chunk (the function refuses a list of another length,
        as the reference's does), keeping the inputs of the chunk with the
        most views (the largest of those) for the timing below."""
        tv = k["transformed_views"]
        rank = (tv.shape[0], tv.numel())
        if rank > fullest.get("rank", (0, 0)):
            fullest.update(rank=rank, views=tv, weights=k["blending_weights"])
        return tdeconv.multi_view_deconvolution(psfs=[psf] * tv.shape[0], **k)

    # 1. fuse() with the deconvolution as fusion function, cold and warm
    fused, out["fuse"] = general_case(
        np, torch, tcore, tea, tf, fuse, f"{len(sims)} views, RL x {DECONV_ITERATIONS}", sims,
        dict(output_chunksize=chunk, fusion_func=deconvolve, fusion_func_kwargs=fkw),
        window=lambda shape: (central_window(shape, chunk), chunk), key=key, say=say,
    )
    res = out["fuse"]
    chunks = res["calls"].get("_fuse_views", 0)
    if chunks < 50 or any(res["launches"].values()):
        raise AssertionError(f"deconv: {chunks} host-tier chunks, launches {res['launches']}")
    rl_chunk_ms = res.get("reduce_ms", 0.0) / chunks

    # 2. sharper than the weighted average of the same views: the beads
    # fill about 0.06 % of the output, so the 99.9th percentile (the
    # example's measure) reads their flanks, which deconvolution narrows;
    # the 99.99th reads their peaks and is the one held
    avg = fuse(sims, transform_key=key, output_chunksize=chunk).data
    pct = {q: {"deconvolved": float(np.percentile(fused.data, q)),
               "weighted_average": float(np.percentile(avg, q))} for q in (99.9, 99.99)}
    out["percentiles"] = pct
    say("percentiles, deconvolved against the weighted-average fuse: " + "; ".join(
        f"{q}th {v['deconvolved']:.1f} against {v['weighted_average']:.1f}"
        for q, v in pct.items()))
    if not pct[99.99]["deconvolved"] > pct[99.99]["weighted_average"]:
        raise AssertionError(f"deconv: the beads are not sharper than the weighted average's: "
                             f"{pct}")
    del fused, avg

    # 3. the fullest chunk's RL alone, and its convolutions
    views, weights = fullest["views"], fullest["weights"]
    n_views = views.shape[0]

    def events_ms(fn, reps):
        fn()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    rl_ms = events_ms(lambda: deconvolve(transformed_views=views, blending_weights=weights,
                                         **fkw), 3)
    psi = views[0].clone()
    k1 = torch.from_numpy(psf).to(device)
    k2 = torch.from_numpy(tdeconv._compute_compound_kernel(0, [psf] * n_views,
                                                           tdeconv.PSFType.EFFICIENT_BAYESIAN))
    k2 = k2.to(device)
    n_convs = 2 * n_views * DECONV_ITERATIONS

    def convolutions():
        for _ in range(n_views * DECONV_ITERATIONS):
            tdeconv._jconvolve(psi, k1, "mirror")
            tdeconv._jconvolve(psi, k2, "constant", 1.0)

    conv_ms = events_ms(convolutions, 1)
    padded = torch.nn.functional.pad(psi, (4,) * 6)[None, None]
    kern = torch.flip(k1, (0, 1, 2))[None, None]
    with full_f32():
        conv3d_ms = events_ms(lambda: torch.nn.functional.conv3d(padded, kern), 5)
    out["rl"] = {"chunks": chunks, "rl_ms_a_chunk_in_fuse": rl_chunk_ms,
                 "chunk_views": n_views, "chunk_shape": list(views.shape[1:]),
                 "rl_ms": rl_ms, "convolutions": n_convs, "conv_ms": conv_ms,
                 "conv_share": conv_ms / rl_ms, "conv3d_ms_a_conv": conv3d_ms}
    say(f"RL: {chunks} chunks, {rl_chunk_ms:.1f} ms a chunk in the warm fuse; the fullest chunk "
        f"({n_views} views of {tuple(views.shape[1:])}) alone {rl_ms:.1f} ms, of which its "
        f"{n_convs} convolutions {conv_ms:.1f} ms ({conv_ms / rl_ms:.0%}; "
        f"{conv_ms / n_convs:.3f} ms a convolution, cuDNN's conv3d of one "
        f"{conv3d_ms:.3f} ms)")
    del views, weights, psi, padded
    fullest.clear()

    # 4. small cases against device="cpu"
    sdims = ["z", "y", "x"]
    osp = tcore.process_output_stack_properties(sims, transform_key=key)
    shape = [int(osp["shape"][d]) for d in sdims]
    mid = central_window(shape, small)
    out["small"] = {}
    for label, extra, start in (
        ("INDEPENDENT", {"psf_type": "INDEPENDENT"}, mid),
        ("INDEPENDENT, lambda_reg 1e-3", {"psf_type": "INDEPENDENT", "lambda_reg": 1e-3}, mid),
        ("sample_boundary_erosion_px 2", {"sample_boundary_erosion_px": 2},
         [mid[0], 0, mid[2]]),
    ):
        kw = dict(transform_key=key, output_chunksize=small,
                  output_stack_properties=window_props(osp, sdims, start, small),
                  fusion_func=deconvolve, fusion_func_kwargs={**fkw, **extra})
        t0 = time.perf_counter()
        got = fuse(sims, **kw).data
        card_s = synced() - t0
        t0 = time.perf_counter()
        ref = fuse(sims, device="cpu", **kw).data
        cpu_s = time.perf_counter() - t0
        lam = extra.get("lambda_reg", 0.0)
        # one ulp of the reference's float32 square root in its Tikhonov
        # step (sqrt(1 + 2 lam x) - 1) / lam * M moves a voxel by
        # 2^-23 M / lam; the convolutions' summation order on the card and
        # on the CPU flips some of them
        tol = UINT_COUNTS + (DECONV_TIKHONOV_FLIPS * 2.0**-23 * float(ref.max()) / lam
                             if lam else 0.0)
        err = int(np.abs(got.astype(np.int64) - ref.astype(np.int64)).max())
        if got.dtype != ref.dtype or got.shape != ref.shape or err > tol:
            raise AssertionError(f"deconv: {label}: {got.dtype} {got.shape} against the CPU's "
                                 f"{ref.dtype} {ref.shape}, max_abs_err {err} > {tol:.2f}")
        zero_rows = int(np.all(got == 0, axis=(0, 2)).sum())
        if "sample_boundary_erosion_px" in extra and zero_rows < 2:
            raise AssertionError(f"deconv: {label}: the boundary was not eroded")
        out["small"][label] = {"start": start, "max_abs_err": err, "tolerance": tol,
                               "card_s": card_s, "cpu_s": cpu_s, "zero_y_rows": zero_rows}
        say(f"{label}: window {tuple(start)} + {small}^3, card {card_s:.2f} s, CPU "
            f"{cpu_s:.1f} s, max_abs_err {err} (tolerance {tol:.2f}), y rows all 0: "
            f"{zero_rows}")

    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {out['phase_s']:.1f} s")
    return out


STITCH_TOLERANCE = {"z": 1.0, "y": 3.0, "x": 3.0}
# each pair's registered shift against the true one, in px
STITCH_PAIR_ATOL = 1e-3
# resolved tile offsets against the truth, after removing the global offset:
# held for the shortest-path resolution of the stitch's pairwise graph. The
# default global optimisation (the reference's Gauss-Seidel sweep, at most
# 500 iterations) does not converge on a grid of 1024 tiles, in the JAX
# package as in the port: its error is printed, not held
STITCH_OFFSET_ATOL = 0.25
# the card's register() against the CPU's on the 4 x 4 corner, in px
STITCH_CORNER_ATOL = 1e-3


def stitch_grid_sims(np, tsi, n, tile, overlap, seed):
    """n x n tiles of tile^3 uint16 cut from one band-limited volume (white
    noise from the seed, a 1.5 px gaussian) at true positions on a grid of
    step ``tile - overlap``; each tile's metadata origin is its true one
    perturbed by integers in [-1, 1] (z) and [-3, 3] (y, x). Returns the
    sims, the true origins and the metadata origins, (n*n, 3) each."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    step = tile - overlap
    extent = (n - 1) * step + tile
    noise = rng.random((tile, extent, extent), dtype=np.float32)
    vol = np.empty_like(noise)
    # the filter in y slabs with a halo of its radius, in parallel (the same
    # values as one call)
    halo, slabs = 7, 8
    bounds = np.linspace(0, extent, slabs + 1).astype(int)

    def smooth(k):
        y0, y1 = bounds[k], bounds[k + 1]
        lo, hi = max(0, y0 - halo), min(extent, y1 + halo)
        vol[:, y0:y1] = gaussian_filter(noise[:, lo:hi], 1.5)[:, y0 - lo:y1 - lo]

    with ThreadPoolExecutor(max_workers=slabs) as ex:
        list(ex.map(smooth, range(slabs)))
    del noise
    vol -= vol.min()
    vol *= 1000.0 / vol.max()
    vol = vol.astype(np.uint16)
    sims, truth, meta = [], [], []
    for iy in range(n):
        for ix in range(n):
            true = np.array([0.0, iy * step, ix * step])
            pert = np.array([rng.integers(-1, 2), rng.integers(-3, 4), rng.integers(-3, 4)])
            data = np.ascontiguousarray(vol[:, iy * step:iy * step + tile,
                                            ix * step:ix * step + tile])
            m = true + pert
            sims.append(tsi.get_sim_from_array(data, dims=["z", "y", "x"],
                                               translation=dict(zip("zyx", m))))
            truth.append(true)
            meta.append(m)
    return sims, np.array(truth), np.array(meta)


def stitch_phase(np, torch, tsi, tcore, tf, tstream, fuse, n, tile, overlap):
    """The stitch phase: stitch() of the north-star grid on the card, cold then warm,
    split into its stages; the resolved offsets against the truth; the output
    against fuse() under the resolved key; register() on the card against
    register(device="cpu") on the grid's 4 x 4 corner."""
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import param_resolution as tpr
    from multiview_stitcher_torch import param_utils as tpu
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch import residency
    from multiview_stitcher_torch import stitch as tstitch
    from multiview_stitcher_torch.ops import candidate_scoring as tcs

    label = "stitch"
    t0 = time.perf_counter()
    sims, truth, meta = stitch_grid_sims(np, tsi, n, tile, overlap, seed=11)
    make_s = time.perf_counter() - t0
    rkw = {"overlap_tolerance": STITCH_TOLERANCE}

    def timed(module, name, spans):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t
            return out

        setattr(module, name, wrapped)
        return fn

    def run():
        """One stitch() from an empty device tile cache: (msims, fused sim,
        wall s, register s, fuse s, the pairwise graph it resolved)."""
        tcore.clear_device_tile_cache()
        msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in sims]
        spans, graphs = {}, []
        resolve = treg.param_resolution.groupwise_resolution

        def keep_graph(g, **k):
            graphs.append(g)
            return resolve(g, **k)

        saved = (timed(tstitch.registration, "register", spans),
                 timed(tstitch.fusion, "fuse", spans))
        treg.param_resolution.groupwise_resolution = keep_graph
        try:
            t = time.perf_counter()
            fused = tstitch.stitch(msims, register_kwargs=rkw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            tstitch.registration.register, tstitch.fusion.fuse = saved
            treg.param_resolution.groupwise_resolution = resolve
        return msims, fused, wall, spans["register"], spans["fuse"], graphs[0]

    _, cold, cold_s, _, _, _ = run()
    del cold
    # the main path's run: counts set to 0 just before, read just after
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    tcs.score_candidates.launches = 0
    uploaded = residency.tile_upload_bytes
    msims, fused, warm_s, register_s, fuse_s, g_pairs = run()
    launches = tf.fuse_translation_3d.launches
    score_launches = tcs.score_candidates.launches
    reg_tel = dict(treg.last_telemetry)
    stream = dict(tstream.last_telemetry)
    tile_bytes = residency.tile_upload_bytes - uploaded
    if launches < 1 or tf.fuse_translation_2d.launches:
        raise AssertionError(f"{label}: fuse_translation_3d launches {launches}, 2d "
                             f"{tf.fuse_translation_2d.launches}")
    if not reg_tel["device_tiles"] or reg_tel["crop_upload_bytes"]:
        raise AssertionError(f"{label}: the registration did not cut its crops on the card: "
                             f"{reg_tel}")
    if not score_launches == reg_tel.get("score_launches") == 2 * reg_tel["batches"] > 0:
        raise AssertionError(f"{label}: score_candidates launches {score_launches}, registration "
                             f"telemetry {reg_tel.get('score_launches')}, {reg_tel['batches']} "
                             f"batches")

    # every pair's registered shift against the true one
    pert = meta - truth
    pair_err = max(
        float(np.abs(np.asarray(d["transform"].data)[:3, 3] - (pert[v] - pert[u])).max())
        for u, v, d in g_pairs.edges(data=True)
    )
    if pair_err > STITCH_PAIR_ATOL:
        raise AssertionError(f"{label}: a pair's shift is {pair_err:.3f} px off the truth")

    # the resolved offsets against the truth, after removing the global offset
    def offset_error(mats):
        reg_origin = np.array([
            tpu.transform_pts(meta[k][None], np.asarray(mats[k]))[0] for k in range(len(mats))
        ])
        err = reg_origin - truth
        return float(np.abs(err - err.mean(axis=0)).max())

    global_opt_err = offset_error([m.transforms["registered"].data for m in msims])
    t0 = time.perf_counter()
    sp_params, _ = tpr.groupwise_resolution(g_pairs, method="shortest_paths")
    shortest_paths_s = time.perf_counter() - t0
    offset_err = offset_error([sp_params[k].data for k in range(len(sims))])
    if offset_err > STITCH_OFFSET_ATOL:
        raise AssertionError(f"{label}: resolved offsets {offset_err:.3f} px from the truth")

    out = fused.data
    expect = (tile,) + ((n - 1) * (tile - overlap) + tile,) * 2
    if out.dtype != np.uint16 or abs(out.shape[1] - expect[1]) > 8 or out.shape[0] > tile + 2:
        raise AssertionError(f"{label}: output {out.shape} {out.dtype}, about {expect} expected")
    ref = fuse([tmsi.get_sim_from_msim(m) for m in msims], transform_key="registered").data
    if ref.shape != out.shape or not np.array_equal(ref, out):
        raise AssertionError(f"{label}: stitch() differs from fuse() under the resolved key")
    del ref

    # register() on the card against the CPU on the 4 x 4 corner
    corner = [sims[iy * n + ix] for iy in range(4) for ix in range(4)]
    t0 = time.perf_counter()
    card = treg.register(corner, transform_key=KEY, device_tiles=True, **rkw)
    corner_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = treg.register(corner, transform_key=KEY, device="cpu", device_tiles=True, **rkw)
    corner_cpu_s = time.perf_counter() - t0
    corner_err = max(float(np.abs(np.asarray(a.data) - np.asarray(b.data)).max())
                     for a, b in zip(card, host))
    if corner_err > STITCH_CORNER_ATOL:
        raise AssertionError(f"{label}: the card's 4 x 4 corner differs from the CPU's by "
                             f"{corner_err:g} px")
    tcore.clear_device_tile_cache()

    split = {
        "graph_and_prune_s": reg_tel["graph_s"] + reg_tel["prune_s"],
        "crop_plan_s": reg_tel["plan_s"],
        "tile_upload_s": reg_tel["upload_s"],
        "pairwise_host_s": reg_tel["pairwise_s"],
        "pairwise_device_ms": reg_tel.get("pairwise_device_ms"),
        "resolve_s": reg_tel["resolve_s"],
        "register_s": register_s,
        "fuse_s": fuse_s,
    }
    log(f"{label}: {n} x {n} tiles of {tile}^3 uint16, overlap {overlap}, metadata off by "
        f"[-1, 1] (z) and [-3, 3] (y, x) px, overlap tolerance {STITCH_TOLERANCE}; grid made in "
        f"{make_s:.1f} s; output {out.shape} {out.dtype}")
    log(f"{label}: cold stitch {cold_s:.3f} s, warm stitch {warm_s:.3f} s; edges "
        f"{reg_tel['edges']}, pruned to {reg_tel['pruned_edges']} pairs in "
        f"{reg_tel['buckets']} crop-shape buckets, {reg_tel['batches']} batches; tiles uploaded "
        f"{tile_bytes} bytes by the registration (crops 0), {stream.get('up_bytes')} bytes by the "
        f"streamed fuse in {stream.get('bands_total')} bands; fuse_translation_3d launches "
        f"{launches}, score_candidates launches {score_launches}")
    log(f"{label}: warm split " + json.dumps(
        {k: (None if v is None else round(v, 4)) for k, v in split.items()}))
    log(f"{label}: every pair's shift within {pair_err:.2g} px of the truth; offsets resolved by "
        f"shortest paths ({shortest_paths_s:.2f} s on the host) within {offset_err:.4f} px of "
        f"the truth, by the default global optimisation within {global_opt_err:.4f} px (not "
        f"held: it stops unconverged at 1024 tiles, as the reference's does); output equal to "
        f"fuse() under the resolved key; 4 x 4 corner: card {corner_card_s:.2f} s, CPU "
        f"{corner_cpu_s:.2f} s, max difference {corner_err:g} px")
    return {
        "launches": int(launches),
        "score_launches": int(score_launches),
        "cold_stitch_s": cold_s,
        "warm_stitch_s": warm_s,
        **split,
        "edges": reg_tel["edges"],
        "pairs": reg_tel["pruned_edges"],
        "buckets": reg_tel["buckets"],
        "batches": reg_tel["batches"],
        "tile_upload_bytes": tile_bytes,
        "stream": stream,
        "pair_max_err_px": pair_err,
        "offset_max_err_px": offset_err,
        "global_opt_offset_max_err_px": global_opt_err,
        "corner_max_err_px": corner_err,
        "corner_card_s": corner_card_s,
        "corner_cpu_s": corner_cpu_s,
        "grid_make_s": make_s,
    }, {"msims": msims, "truth": truth, "meta": meta, "sp_params": sp_params}


# the metrics phase: the summary NCC under the true positions, at least; the
# card's pair values against device="cpu" on the grid's 4 x 4 corner
METRICS_TRUTH_MIN = 0.999
METRICS_CORNER_ATOL = 1e-4


def metrics_phase(np, torch, tea, tf, msims, truth, meta, sp_params, n):
    """The metrics phase: tile_pair_image_metrics of the stitch phase's n x n
    grid after its warm stitch(), the pairs from the overlaps under the
    metadata key, scored under four keys: the true positions, the metadata,
    the default register() key and the shortest-paths resolution of the same
    pairwise graph; the batched NCC on the card (the five kernels' launches
    counted from 0 just before it), split into the host's graph and
    geometry, grids, source windows and the device time. Held: the truth's
    summary NCC at least METRICS_TRUTH_MIN and above the metadata's; the
    4 x 4 corner's pairs within METRICS_CORNER_ATOL of device="cpu", by the
    batched NCC and by the host loop with NCC and SSIM."""
    from multiview_stitcher_torch import metrics as tmetrics
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import param_utils as tpu

    card = card_line()
    t_phase = time.perf_counter()
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = {}

    def say(msg):
        log(f"[{card}] metrics: {msg}")

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    def launch_counts():
        counts = {k: getattr(tea, k).launches for k in EXACT_WRAPPERS}
        counts.update(fuse_translation_2d=tf.fuse_translation_2d.launches,
                      fuse_translation_3d=tf.fuse_translation_3d.launches)
        return counts

    def zero_counts():
        for k in EXACT_WRAPPERS:
            getattr(tea, k).launches = 0
        tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0

    for k, m in enumerate(msims):
        tmsi.set_affine_transform(
            m, tpu.affine_to_xaffine(tpu.affine_from_translation(truth[k] - meta[k])),
            transform_key="truth")
        tmsi.set_affine_transform(m, sp_params[k], transform_key="shortest_paths")
    keys = ["truth", KEY, "registered", "shortest_paths"]
    kw = dict(base_transform_key=KEY, query_transform_keys=keys)

    # 1. the whole grid, batched NCC on the card
    zero_counts()
    t0 = time.perf_counter()
    res = tmetrics.tile_pair_image_metrics(msims, **kw)
    wall = synced() - t0
    launches = launch_counts()
    tel = dict(tmetrics.last_telemetry)
    summary = {q: res["summary"][q]["ncc"] for q in keys}
    out.update(wall_s=wall, launches=launches, summary_ncc=summary, pairs=len(res["pairs"]),
               **{k: tel[k] for k in ("graph_s", "plan_s", "prepare_s", "device_ms",
                                      "buckets", "units", "edges")})
    device_ms = "not measured" if tel["device_ms"] is None else f"{tel['device_ms']:.1f} ms"
    say(f"{n} x {n} grid: {len(res['pairs'])} pairs x {len(keys)} keys = {tel['units']} units "
        f"in {tel['buckets']} shape buckets, {wall:.2f} s: graph and edge geometry "
        f"{tel['graph_s']:.2f} s, grids {tel['plan_s']:.2f} s, source windows and slabs "
        f"{tel['prepare_s']:.2f} s (host), device {device_ms}; kernel launches "
        f"{json.dumps(launches)}")
    say("summary NCC by key: " + json.dumps({q: round(v, 6) for q, v in summary.items()}))
    if any(launches.values()):
        raise AssertionError(f"metrics: the batched NCC launched {launches}")
    if not (summary["truth"] >= METRICS_TRUTH_MIN and summary["truth"] > summary[KEY]):
        raise AssertionError(f"metrics: summary NCC {summary}")
    del res

    # 2. the 4 x 4 corner on the card against device="cpu", both paths
    corner = [msims[iy * n + ix] for iy in range(4) for ix in range(4)]
    funcs = {"batched NCC": None,
             "host loop, NCC and SSIM": {"ncc": tmetrics.normalized_cross_correlation,
                                         "ssim": tmetrics.structural_similarity}}
    out["corner"] = {}
    for label, metric_funcs in funcs.items():
        mkw = dict(kw, metric_funcs=metric_funcs)
        zero_counts()
        t0 = time.perf_counter()
        got = tmetrics.tile_pair_image_metrics(corner, **mkw)
        card_s = synced() - t0
        corner_launches = launch_counts()
        t0 = time.perf_counter()
        ref = tmetrics.tile_pair_image_metrics(corner, device="cpu", **mkw)
        cpu_s = time.perf_counter() - t0
        if list(got["pairs"]) != list(ref["pairs"]):
            raise AssertionError(f"metrics: corner ({label}): pairs differ from the CPU's")
        err = max(abs(v - ref["pairs"][e][q][m])
                  for e, per_key in got["pairs"].items() for q, vals in per_key.items()
                  for m, v in vals.items())
        out["corner"][label] = {"pairs": len(got["pairs"]), "max_abs_err": err, "card_s": card_s,
                                "cpu_s": cpu_s, "launches": corner_launches}
        say(f"4 x 4 corner, {label}: {len(got['pairs'])} pairs, card {card_s:.2f} s, CPU "
            f"{cpu_s:.2f} s, max_abs_err {err:.3g}; kernel launches on the card "
            f"{json.dumps({k: v for k, v in corner_launches.items() if v})}")
        if not err <= METRICS_CORNER_ATOL:
            raise AssertionError(f"metrics: corner ({label}) differs from the CPU by {err}")

    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# zarr3: phase 5's tiles fused into NGFF 0.5, sharded
# ---------------------------------------------------------------------------

ZARR3_SHARDS = (64, 512, 512)


def count_files(root) -> int:
    return sum(1 for f in Path(root).rglob("*") if f.is_file())


def zarr3_phase(np, torch, tf, tstream, fuse, lazy, work, v2_url, v2_warm_s,
                shards=ZARR3_SHARDS):
    """``zarr3:`` lines: phase 5's 1024 lazy zarr tiles fused zarr -> zarr
    into an NGFF 0.5 OME-Zarr (zarr v3), level 0 in chunks of 128 and shards
    of ``ZARR3_SHARDS``, cold and warm (the device tile cache emptied before
    each); the streaming tier's bands align to
    whole shards. Held: every level bit-equal to phase 5's v2 store at
    ``v2_url``, the group's ``ome`` attributes at version 0.5, level 0
    sharded; printed: the files of each store and the warm time beside
    phase 5's. ``shards`` is level 0's shard shape."""
    from multiview_stitcher_torch.fusion import _core as tcore
    from multiview_stitcher_torch.io import zarr_backend

    label = "zarr3"
    out_url = str(work / "fused_v3.ome.zarr")
    opts = {"ngff_version": "0.5",
            "zarr_array_creation_kwargs": {"shards": list(shards)}}
    runs = {}
    for run in ("cold", "warm"):
        tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
        # each run reads its tiles, as phase 5's warm run does
        tcore.clear_device_tile_cache()
        t0 = time.perf_counter()
        res = fuse(lazy, transform_key=KEY, output_chunksize=128, output_zarr_url=out_url,
                   zarr_options=opts)
        torch.cuda.synchronize()
        runs[run] = {"wall_s": time.perf_counter() - t0, **tstream.last_telemetry}
    tele = runs["warm"]
    launches = tf.fuse_translation_3d.launches
    if launches != tele["bands_total"] or tele["band_height"] % shards[tele["band_axis"]]:
        raise AssertionError(f"{label}: launches {launches}, bands {tele}")
    attrs, fmt = zarr_backend.read_group_metadata(out_url)
    v2_attrs, _ = zarr_backend.read_group_metadata(v2_url)
    ms = attrs["ome"]["multiscales"][0]
    if fmt != 3 or attrs["ome"]["version"] != "0.5" or [d["path"] for d in ms["datasets"]] != [
            d["path"] for d in v2_attrs["multiscales"][0]["datasets"]]:
        raise AssertionError(f"{label}: group metadata {attrs}")
    level0 = zarr_backend.open_zarr_array(out_url + "/0")
    if level0.zarr_format != 3 or level0.shards != tuple(shards) or res.data.zarr_format != 3:
        raise AssertionError(f"{label}: level 0 is zarr {level0.zarr_format}, shards {level0.shards}")
    for ds in ms["datasets"]:
        a = np.asarray(zarr_backend.open_zarr_array(f"{out_url}/{ds['path']}"))
        b = np.asarray(zarr_backend.open_zarr_array(f"{v2_url}/{ds['path']}"))
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{label}: level {ds['path']} differs from the v2 store")
    files = {"v3": count_files(out_url), "v2": count_files(v2_url),
             "v3_level0": count_files(out_url + "/0"), "v2_level0": count_files(v2_url + "/0")}
    mvox = level0.shape[0] * level0.shape[1] * level0.shape[2] / 1e6
    for run, r in runs.items():
        log(f"{card_line()} {label} {run}: wall {r['wall_s']:.3f} s, {mvox / r['wall_s']:.1f} "
            f"Mvox/s out, bands {r['bands_total']} of {r['band_height']} rows on axis "
            f"{r['band_axis']}, NV {r['nv']}, up {r['up_bytes'] / 1e6:.1f} MB")
    log(f"{card_line()} {label}: every level bit-equal to phase 5's v2 store; files "
        f"{files['v3']} (level 0 {files['v3_level0']}) against v2's {files['v2']} (level 0 "
        f"{files['v2_level0']}); warm {runs['warm']['wall_s']:.3f} s against phase 5's "
        f"{v2_warm_s:.3f} s")
    return {"launches": int(launches), "files": files, "out_mvox": mvox,
            "v2_warm_s": v2_warm_s, **{run: r for run, r in runs.items()}}


# ---------------------------------------------------------------------------
# slabs: lazy views larger than TILES_MAX_BYTES through host slabs
# ---------------------------------------------------------------------------

SLAB_SHAPE = (384, 1024, 1024)
SLAB_ANGLES = (0, 45, 90, 135)
SLAB_CHUNK = 256
SLAB_STORE_CHUNKS = (64, 64, 64)
SLAB_WINDOW = (64, 256, 256)


class SlabTimer(StageTimer):
    """:class:`StageTimer` for the host-slab route: the plan ends where the
    slab reads start (``fusion._core._iter_slabs``); kernel, blend and
    download by CUDA events as there, the uploads from the route's events."""

    def __enter__(self):
        super().__enter__()
        tcore = self.tcore
        self._saved_iter = tcore._iter_slabs

        def iter_slabs(*a, **k):
            self.t_upload_start = time.perf_counter()
            return self._saved_iter(*a, **k)

        tcore._iter_slabs = iter_slabs
        return self

    def __exit__(self, *exc):
        self.tcore._iter_slabs = self._saved_iter
        return super().__exit__(*exc)


def slabs_phase(np, torch, tsi, tcore, tea, tf, fuse, work, shape=SLAB_SHAPE,
                chunk=SLAB_CHUNK, store_chunks=SLAB_STORE_CHUNKS, window=SLAB_WINDOW):
    """``slabs:`` lines: four lazy zarr v2 views of ``shape`` uint16, rotated
    about y by 0, 45, 90 and 135 degrees, together above
    ``TILES_MAX_BYTES`` (not patched): ``fuse()`` takes the batched tier's
    host slabs (each chunk's windows read from the zarr arrays, packed into
    (B, K, *S_max) slabs, uploaded through pinned buffers one batch ahead),
    kernel 4 on them. Cold and warm, the warm call split into plan, read,
    pack, upload, kernel, blend and download; window bytes read against tile
    bytes; peak device memory beside the same views fused from memory
    through the device stack. Held: within 1 count of that device-stack
    output and, on a ``window`` of the output, of ``device="cpu"``; no tile
    stacked or uploaded; kernel 4 against its plain version on the fullest
    slab batch. Returns (results, the slab launches of the five wrappers)."""
    from multiview_stitcher_torch import residency
    from multiview_stitcher_torch.io import zarr_backend

    label = "slabs"
    wrappers = {n: getattr(tea, n) for n in EXACT_WRAPPERS}

    def counts():
        return {n: w.launches for n, w in wrappers.items()} | {
            "fuse_translation_2d": tf.fuse_translation_2d.launches,
            "fuse_translation_3d": tf.fuse_translation_3d.launches}

    def zero():
        for w in wrappers.values():
            w.launches = 0
        tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0

    t0 = time.perf_counter()
    sims = multiview_sims(np, tsi, shape, SLAB_ANGLES, seed=11)
    make_s = time.perf_counter() - t0
    tile_bytes = sum(s.data.nbytes for s in sims)
    if tile_bytes <= tcore.TILES_MAX_BYTES:
        raise AssertionError(f"{label}: {tile_bytes} bytes of views fit under the limit")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        lazy = []
        for i, s in enumerate(sims):
            url = str(work / f"view_{i}.zarr")
            zarr_backend.create_zarr_array(url, s.data.shape, store_chunks, s.data.dtype)[...] = s.data
            sim = tsi.get_sim_from_array(zarr_backend.open_zarr_array(url), dims=s.dims,
                                         translation=dict(s.origin))
            tsi.set_sim_affine(sim, s.transforms[KEY].data, transform_key=KEY)
            lazy.append(sim)
        write_s = time.perf_counter() - t0
        uploaded = residency.tile_upload_bytes
        runs = {}
        for run in ("cold", "warm"):
            tcore.clear_device_tile_cache()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero()
            with SlabTimer(torch, tcore, tf, tea) as st:
                t0 = time.perf_counter()
                out = fuse(lazy, transform_key=KEY, output_chunksize=chunk).data
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                split = st.split_ms(t0, t1)
            tele = dict(tcore.last_slab_telemetry)
            events = tele.pop("upload_events", [])
            split["upload_ms"] = sum(e0.elapsed_time(e1) for e0, e1 in events)
            split["read_ms"], split["pack_ms"] = tele["read_s"] * 1e3, tele["pack_s"] * 1e3
            runs[run] = {"wall_s": t1 - t0, "peak_bytes": torch.cuda.max_memory_allocated(),
                         "launches": counts(), **split, **tele}
        launched = runs["warm"]["launches"]
        sepy = "exact_affine_batch_3d_sepy"
        if launched[sepy] < 2 or any(v for n, v in launched.items() if n != sepy):
            raise AssertionError(f"{label}: launches {launched}, expected kernel 4 only")
        tele = runs["warm"]
        if (tele["tier"], tele["route"]) != ("batched", "exact") or (
                residency.tile_upload_bytes != uploaded):
            raise AssertionError(f"{label}: route {tele['tier']}/{tele['route']}, tile bytes "
                                 f"uploaded {residency.tile_upload_bytes - uploaded}")
        top = max(int(s.data.max()) for s in sims)
        if out.dtype != np.uint16 or out.ndim != 3 or int(out.max()) > top or not out.any():
            raise AssertionError(f"{label}: output {out.shape} {out.dtype}")

        # kernel 4 on the fullest slab batch of the warm run (uint16 slabs,
        # no tile_idx), against its plain version on the same inputs
        args, kw = st.kernel_call
        st = None
        got = tea.exact_affine_batch_3d_sepy(*args, **kw)
        ref_b = tea.exact_affine_batch_3d_sepy_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(ref_b)):
            raise AssertionError(f"{label}: slab batch masks differ from the plain version")
        slab_err = float((torch.nan_to_num(got) - torch.nan_to_num(ref_b)).abs().max())
        del got, ref_b
        # uint16 data up to `top`: the f32 ulps of the coordinate scale with the value
        if slab_err > EXACT_ATOL * max(top, 100) / 100:
            raise AssertionError(f"{label}: slab batch differs from the plain version by {slab_err}")
        packed = tea._check_args(3, args[0], *args[1:5], kw["cval"], None, None, kw["valid"])
        slab_kernel_ms = time_kernel_ms(torch, tea._launch, (tea._ENTRY_POINTS[1], packed), {},
                                        reps=10)
        slab_batch = list(args[0].shape)
        del args, kw, packed

        # the same views from memory, through the device stack
        tcore.clear_device_tile_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = fuse(sims, transform_key=KEY, output_chunksize=chunk).data
        torch.cuda.synchronize()
        stack_s = time.perf_counter() - t0
        stack_peak = torch.cuda.max_memory_allocated()
        tcore.clear_device_tile_cache()
        diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
        err, n_diff = int(diff.max()), int(np.count_nonzero(diff))
        del diff, ref
        if err > UINT_COUNTS:
            raise AssertionError(f"{label}: differs from the device-stack output by {err}")

        # a window of the output on the CPU, from the same lazy views
        sdims = ["z", "y", "x"]
        osp = tcore.process_output_stack_properties(lazy, transform_key=KEY)
        start = [(n - w) // 2 // chunk * chunk for n, w in zip(out.shape, window)]
        props = {"shape": dict(zip(sdims, window)), "spacing": dict(osp["spacing"]),
                 "origin": {d: osp["origin"][d] + start[i] * osp["spacing"][d]
                            for i, d in enumerate(sdims)}}
        t0 = time.perf_counter()
        cpu = fuse(lazy, transform_key=KEY, output_chunksize=chunk,
                   output_stack_properties=props, device="cpu").data
        cpu_s = time.perf_counter() - t0
        got = out[tuple(slice(a, a + w) for a, w in zip(start, window))]
        cpu_err = int(np.abs(got.astype(np.int32) - cpu.astype(np.int32)).max())
        if cpu_err > UINT_COUNTS:
            raise AssertionError(f"{label}: window differs from device='cpu' by {cpu_err}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    mvox = out.size / 1e6
    stack_need = tile_bytes + 2 * tile_bytes  # the uint16 stack and its f32 copy
    for run, r in runs.items():
        log(f"{card_line()} {label} {run}: output {out.shape} {out.dtype}, fuse {r['wall_s']:.3f} s, "
            f"{mvox / r['wall_s']:.1f} Mvox/s out, {r['units']} batches, {r['windows']} windows, "
            f"read {r['window_bytes'] / 1e9:.3f} GB of windows against {tile_bytes / 1e9:.3f} GB "
            f"of tiles, uploaded {r['upload_bytes'] / 1e9:.3f} GB, peak device memory "
            f"{r['peak_bytes'] / 1e9:.3f} GB, kernel 4 launches {r['launches'][sepy]}")
    w = runs["warm"]
    log(f"{card_line()} {label} warm split ms: " + json.dumps({
        k: round(w[k], 1) for k in ("plan_ms", "read_ms", "pack_ms", "upload_ms", "kernel_ms",
                                    "blend_ms", "download_ms", "other_ms") if k in w})
        + " (read and pack on the reader threads, beside the rest)")
    log(f"{card_line()} {label}: device-stack route from memory {stack_s:.3f} s, peak "
        f"{stack_peak / 1e9:.3f} GB (its stack {tile_bytes / 1e9:.3f} GB, with an f32 copy "
        f"{stack_need / 1e9:.3f} GB) against the slabs' {w['peak_bytes'] / 1e9:.3f} GB; "
        f"{n_diff} voxels differ by 1 count; window {window} on the CPU in {cpu_s:.1f} s, max "
        f"{cpu_err} counts; views made in {make_s:.1f} s, written in {write_s:.1f} s; kernel 4 "
        f"on the fullest slab batch {slab_batch} {slab_kernel_ms:.4f} ms, {slab_err:.3g} from "
        f"its plain version")
    if w["peak_bytes"] >= stack_peak:
        raise AssertionError(f"{label}: slabs peak {w['peak_bytes']} not below the device "
                             f"stack's {stack_peak}")
    return {"tile_bytes": tile_bytes, "out_shape": list(out.shape), "out_mvox": mvox,
            "max_abs_err_counts": err, "voxels_differ": n_diff, "cpu_window_err": cpu_err,
            "cpu_window_s": cpu_s, "stack_fuse_s": stack_s, "stack_peak_bytes": stack_peak,
            "stack_with_f32_bytes": stack_need, "slab_kernel_ms": slab_kernel_ms,
            "slab_kernel_max_abs_err": slab_err, "slab_batch": slab_batch, "make_s": make_s,
            "write_s": write_s,
            **{run: r for run, r in runs.items()}}, launched


# ---------------------------------------------------------------------------
# shear: the shear tier with MVS_TPU_SHEAR=1
# ---------------------------------------------------------------------------

SHEAR_SHAPE = (256, 512, 512)
SHEAR_VIEWS = 4
SHEAR_THETA = 0.05
SHEAR_CHUNK = 128


def shear_views(np, tsi, shape, n_views, theta):
    """The reference's shear-tier layout (tests/test_shear.py::_rotated_sims)
    at ``shape``: ``n_views`` copies of one smooth volume (a sum of sines
    x 100, as uint16, the content of those tests) in a row along x, 3/4 of a
    view apart, every other one rotated by ``theta`` in (y, x)."""
    axes = [np.linspace(0, 3 * np.pi, n, dtype=np.float32) for n in shape]
    vol = (np.sin(axes[0])[:, None, None] + np.sin(axes[1] + 1)[None, :, None]
           + np.sin(axes[2] + 2)[None, None, :] + 3.0)
    data = (vol * 100).astype(np.uint16)
    rot = np.eye(4)
    rot[1:3, 1:3] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    sims = [
        tsi.get_sim_from_array(data.copy(), dims=["z", "y", "x"],
                               translation={"z": 0.0, "y": 0.0, "x": i * 0.75 * shape[2]})
        for i in range(n_views)
    ]
    return with_affine(tsi, sims, [rot if i % 2 else np.eye(4) for i in range(n_views)])


def shear_phase(np, torch, tsi, tcore, tea, tf, fuse, shape=SHEAR_SHAPE, n_views=SHEAR_VIEWS,
                theta=SHEAR_THETA, chunk=SHEAR_CHUNK):
    """``shear:`` lines: four (256, 512, 512) uint16 views of one smooth
    volume (:func:`shear_views`), fused with ``MVS_TPU_SHEAR=1`` set only
    inside this phase: the shear tier's passes as torch ops, no kernel
    launched. Not the affine path's multi-view views: the shear planner (the
    reference's) factors every map of a plan under one axis order and bounds
    each pass's intermediate extent at 3 times the chunk's or the window's
    (``max_growth``), and the windows of views rotated about the common
    centre, cut at the views' borders, spread the maps' offsets beyond that
    at every chunk size, in both packages; their plan is None and the gather
    route would take them. Printed: cold and warm ``fuse()``, batches, the
    plan's passes, the tier's time. Held: the output within the reference's
    shear tolerance of the exact kernels' output of the same views
    (tests/test_shear.py: 99th percentile of the difference under 3 counts,
    mean under 0.5, under 0.2 % of voxels off by more than 5 % of the
    maximum)."""
    label = "shear"
    sims = shear_views(np, tsi, shape, n_views, theta)
    t0 = time.perf_counter()
    exact = fuse(sims, transform_key=KEY, output_chunksize=chunk).data
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    wrappers = [getattr(tea, n) for n in EXACT_WRAPPERS]
    plans, events = [], []
    orig_plan, orig_batch = tcore._plan_shear_bundle, tcore._fuse_chunk_batch_kernel_shear

    def plan(*a, **k):
        plans.append(orig_plan(*a, **k))
        return plans[-1]

    def batch(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = orig_batch(*a, **k)
        e1.record()
        events.append((e0, e1))
        return res

    tcore._plan_shear_bundle, tcore._fuse_chunk_batch_kernel_shear = plan, batch
    os.environ["MVS_TPU_SHEAR"] = "1"
    try:
        runs = {}
        for run in ("cold", "warm"):
            tcore.clear_device_tile_cache()
            events.clear()
            for w in wrappers:
                w.launches = 0
            t0 = time.perf_counter()
            out = fuse(sims, transform_key=KEY, output_chunksize=chunk).data
            torch.cuda.synchronize()
            runs[run] = {"wall_s": time.perf_counter() - t0, "batches": len(events),
                         "tier_ms": sum(e0.elapsed_time(e1) for e0, e1 in events),
                         "kernel_launches": sum(w.launches for w in wrappers)}
    finally:
        del os.environ["MVS_TPU_SHEAR"]
        tcore._plan_shear_bundle, tcore._fuse_chunk_batch_kernel_shear = orig_plan, orig_batch
    bundle = plans[-1]
    if bundle is None or not runs["warm"]["batches"] or runs["warm"]["kernel_launches"]:
        raise AssertionError(f"{label}: plan {bundle}, runs {runs}")
    d = np.abs(out.astype(np.float64) - exact.astype(np.float64))
    stats = {"p99": float(np.percentile(d, 99)), "mean": float(d.mean()),
             "share_off_5pct": float((d > 0.05 * exact.max()).mean()), "max": float(d.max())}
    del d
    if not (stats["p99"] < 3.0 and stats["mean"] < 0.5 and stats["share_off_5pct"] < 0.002):
        raise AssertionError(f"{label}: against the exact kernels {stats}")
    splan, _, wplan, _ = bundle
    for run, r in runs.items():
        log(f"{card_line()} {label} {run}: output {out.shape}, fuse {r['wall_s']:.3f} s, "
            f"{out.size / 1e6 / r['wall_s']:.1f} Mvox/s out, {r['batches']} batches, the tier "
            f"{r['tier_ms']:.1f} ms (CUDA events), kernel launches {r['kernel_launches']}")
    log(f"{card_line()} {label}: plan perm {splan.perm}, {splan.n_passes} passes "
        f"{[p[:2] for p in splan.passes]}, weights {wplan.n_passes} passes; against the exact "
        f"kernels' fuse ({exact_s:.3f} s): " + json.dumps({k: round(v, 4) for k, v in stats.items()}))
    return {"views": n_views, "theta": theta, "passes": splan.n_passes, "perm": list(splan.perm),
            "weight_passes": wplan.n_passes, "exact_fuse_s": exact_s, **stats,
            **{run: r for run, r in runs.items()}}


# ---------------------------------------------------------------------------
# the readers: files written here, read by the port's readers, fused on the card
# ---------------------------------------------------------------------------

# the CZI slide scan: 16 x 16 tiles of 1024^2 uint16, 2 channels, 10 % overlap,
# its stage positions off by integers in [-3, 3] px, 0.5 um pixels
READERS_MOSAIC_N = 16
READERS_MOSAIC_TILE = 1024
READERS_MOSAIC_OVERLAP = 102
READERS_MOSAIC_ERROR = 3
READERS_SPACING = 0.5
READERS_WINDOW = 2048
READERS_OFFSET_ATOL = 0.25
# the multi-view CZI (a Lightsheet Z.1 layout): four views about y
READERS_MV_SHAPE = (256, 512, 512)
READERS_MV_ANGLES = (0, 90, 180, 270)
READERS_MV_WINDOW = 128
# the TIFF tile grid: 4 x 4 deflate TIFFs of (64, 512, 512), overlap 64
READERS_TIFF_N = 4
READERS_TIFF_TILE = (64, 512, 512)
READERS_TIFF_OVERLAP = 64
# the codecs' rate lines: an 8 MB uint16 image (LZW, PackBits), 64 MB (deflate
# with predictor 2)
READERS_CODEC_SHAPE = (2048, 2048)
READERS_DEFLATE_SHAPE = (4096, 8192)
# optional packages of the readers, probed in a child process
READERS_OPTIONAL = ("h5py", "imageio", "PIL", "zstandard", "imagecodecs", "aicsimageio")


def czi_segment_header(sid, size):
    """The 32-byte header of a ZISRAW segment of ``size`` data bytes
    (allocated rounded up to 32)."""
    import struct

    allocated = -(-size // 32) * 32
    return sid.encode().ljust(16, b"\0") + struct.pack("<qq", allocated, size), allocated - size


def write_czi(path, xml, planes):
    """Write a ZISRAW (CZI) file: the file header, the metadata segment, one
    subblock segment a plane (each with a small metadata block before its
    pixels) and a trailing DELETED segment the readers skip. ``planes``
    yields (dims, pixel type, compression, payload): ``dims`` maps each
    dimension letter to (start, size), the payload is the subblock's bytes
    (a contiguous numpy array for raw pixels). Returns the bytes written.
    The reader tests write their CZI files with it too."""
    import struct

    sub_meta = b"<METADATA><Tags/></METADATA>"

    with open(path, "wb") as f:
        body = (struct.pack("<iiii", 1, 0, 0, 0) + b"\x11" * 32
                + struct.pack("<iqqiq", 0, 0, 0, 0, 0)).ljust(512, b"\0")
        head, pad = czi_segment_header("ZISRAWFILE", len(body))
        f.write(head + body + b"\0" * pad)
        xml_bytes = xml.encode()
        body = struct.pack("<ii", len(xml_bytes), 0).ljust(256, b"\0") + xml_bytes
        head, pad = czi_segment_header("ZISRAWMETADATA", len(body))
        f.write(head + body + b"\0" * pad)
        for dims, pixel_type, compression, payload in planes:
            payload = memoryview(payload).cast("B")
            entry = b"DV" + struct.pack("<iqii", pixel_type, f.tell(), 0, compression)
            entry += b"\0" * 6 + struct.pack("<i", len(dims))
            for name, (start, size) in dims.items():
                entry += name.encode().ljust(4, b"\0") + struct.pack("<iifi", start, size,
                                                                     float(start), size)
            lead = (struct.pack("<iiq", len(sub_meta), 0, payload.nbytes)
                    + entry).ljust(256, b"\0") + sub_meta
            head, pad = czi_segment_header("ZISRAWSUBBLOCK", len(lead) + payload.nbytes)
            f.write(head + lead)
            f.write(payload)
            f.write(b"\0" * pad)
        head, pad = czi_segment_header("DELETED", 64)
        f.write(head + b"\0" * (64 + pad))
        return f.tell()


def czi_metadata_xml(spacing_um, channels, views=None, center=None):
    """The CZI metadata the readers use: scaling, channel names, the
    multi-view positions (x, y, z in um, angle in degrees) and the
    ``CenterPosition``."""
    dist = "".join(f'<Distance Id="{d}"><Value>{v * 1e-6!r}</Value></Distance>'
                   for d, v in spacing_um.items())
    chans = "".join(f'<Channel Id="Channel:{i}" Name="{n}"/>' for i, n in enumerate(channels))
    mv = ""
    if views is not None:
        mv = "<MultiView>" + "".join(
            f"<View><PositionX>{x!r}</PositionX><PositionY>{y!r}</PositionY>"
            f"<PositionZ>{z!r}</PositionZ><Angle>{a!r}</Angle></View>" for x, y, z, a in views
        ) + "</MultiView>"
    if center is not None:
        mv += "<CenterPosition>" + ",".join(repr(float(c)) for c in center) + "</CenterPosition>"
    return ("<ImageDocument><Metadata><Scaling><Items>" + dist + "</Items></Scaling>"
            "<Information><Image><Dimensions><Channels>" + chans + "</Channels></Dimensions>"
            "</Image></Information><Experiment>" + mv + "</Experiment></Metadata>"
            "</ImageDocument>")


def probe_modules(names):
    """Whether each module imports, each in a child process (this one
    imports none of them)."""
    return {m: subprocess.run([sys.executable, "-c", f"import {m}"], capture_output=True,
                              timeout=120).returncode == 0 for m in names}


class ReadCounter:
    """Counts the bytes and seconds of the CZI reader's subblock reads, by
    the stage (``stage`` attribute) they happen in."""

    def __init__(self, tczi):
        self.tczi, self.stage, self.bytes, self.seconds = tczi, "other", {}, {}
        self._lock = threading.Lock()

    def __enter__(self):
        read = self._read = self.tczi.CziFile.read_subblock

        def counted(czi, sb):
            t = time.perf_counter()
            out = read(czi, sb)
            dt = time.perf_counter() - t
            with self._lock:
                self.bytes[self.stage] = self.bytes.get(self.stage, 0) + sb.data_size
                self.seconds[self.stage] = self.seconds.get(self.stage, 0.0) + dt
            return out

        self.tczi.CziFile.read_subblock = counted
        return self

    def __exit__(self, *exc):
        self.tczi.CziFile.read_subblock = self._read
        return False


def readers_codecs(np, torch, say, shape=READERS_CODEC_SHAPE, deflate_shape=READERS_DEFLATE_SHAPE):
    """The native codec build (timed; it must take the native route) and the
    decode rates of the native decoders against the Python ones, each output
    bit-equal: LZW and PackBits on an uint16 image of ``shape``, deflate with
    predictor 2 on one of ``deflate_shape``."""
    import zlib

    from multiview_stitcher_torch.io import codecs

    fresh = not codecs.library_path().exists()
    t0 = time.perf_counter()
    route = codecs.native_route()
    build_s = time.perf_counter() - t0
    if route != "native":
        raise AssertionError(f"readers: the TIFF codecs took the {route} route "
                             f"(compiler {codecs.compiler()})")
    say(f"native codecs {'built' if fresh else 'loaded'} in {build_s:.3f} s with "
        f"{codecs.compiler()} into {codecs.library_path().relative_to(REPO)}")

    def rate(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t

    img = smooth_noise(torch, shape, seed=21, device="cuda")
    raw = img.tobytes()
    out = {"build_s": build_s, "route": route, "compiler": codecs.compiler()}
    for name, enc, native, plain in (
        ("lzw", codecs.lzw_encode, codecs.lzw_decode, codecs._lzw_decode_py),
        ("packbits", codecs.packbits_encode, codecs.packbits_decode, codecs._packbits_decode_py),
    ):
        data, enc_s = rate(enc, raw)
        got, native_s = rate(native, data, len(raw))
        ref, plain_s = rate(plain, data, len(raw))
        if got != raw or ref != raw:
            raise AssertionError(f"readers: {name} decode differs from the image")
        out[name] = {"mb": len(raw) / 1e6, "ratio": len(data) / len(raw), "encode_s": enc_s,
                     "native_mb_s": len(raw) / 1e6 / native_s,
                     "python_mb_s": len(raw) / 1e6 / plain_s}
    big = smooth_noise(torch, deflate_shape, seed=22, device="cuda")
    diff = np.diff(big.astype(np.int64), axis=-1, prepend=0).astype(np.uint16)
    data, enc_s = rate(zlib.compress, diff.tobytes())

    def decode(undo):
        arr = np.frombuffer(codecs.deflate_decode(data, big.nbytes), np.uint16).reshape(big.shape)
        return undo(arr)

    got, native_s = rate(decode, codecs.undo_predictor2)
    ref, plain_s = rate(decode, codecs._undo_predictor2_py)
    _, inflate_s = rate(codecs.deflate_decode, data, big.nbytes)
    if not (np.array_equal(got, big) and np.array_equal(ref, big)):
        raise AssertionError("readers: deflate + predictor 2 decode differs from the image")
    out["deflate_predictor2"] = {"mb": big.nbytes / 1e6, "ratio": len(data) / big.nbytes,
                                 "encode_s": enc_s, "inflate_mb_s": big.nbytes / 1e6 / inflate_s,
                                 "native_mb_s": big.nbytes / 1e6 / native_s,
                                 "python_mb_s": big.nbytes / 1e6 / plain_s}
    for name in ("lzw", "packbits", "deflate_predictor2"):
        r = out[name]
        say(f"decode {name}: {r['mb']:.1f} MB (compressed to {r['ratio']:.3f}), native "
            f"{r['native_mb_s']:.1f} MB/s, Python {r['python_mb_s']:.2f} MB/s, bit-equal"
            + (f"; zlib alone {r['inflate_mb_s']:.1f} MB/s" if "inflate_mb_s" in r else ""))
    return out


def write_slide_scan(np, torch, work, n, tile, overlap):
    """The CZI slide scan of the ``readers:`` and ``service:`` phases: n x n
    tiles of tile^2 uint16 in 2 channels cut from one band-limited image
    (made on the card from a seed) at their true grid positions, written as
    raw subblocks whose X/Y starts hold the true positions plus an integer
    error in [-READERS_MOSAIC_ERROR, READERS_MOSAIC_ERROR]. Returns the
    path, the true and written (y, x) starts in pixels, the bytes written
    and the seconds it took."""
    rng = np.random.default_rng(23)
    step = tile - overlap
    extent = (n - 1) * step + tile
    t0 = time.perf_counter()
    image = smooth_noise(torch, (2, extent, extent), seed=23, device="cuda")
    truth, starts = [], []
    for iy in range(n):
        for ix in range(n):
            y0, x0 = iy * step, ix * step
            err = rng.integers(-READERS_MOSAIC_ERROR, READERS_MOSAIC_ERROR + 1, 2)
            truth.append((y0, x0))
            starts.append((y0 + err[0], x0 + err[1]))
    truth, starts = np.asarray(truth, float), np.asarray(starts)

    def subblocks():
        for m, (ys, xs) in enumerate(starts):
            y0, x0 = (int(v) for v in truth[m])
            for c in range(2):
                plane = np.ascontiguousarray(image[c, y0:y0 + tile, x0:x0 + tile])
                yield ({"X": (int(xs), tile), "Y": (int(ys), tile), "C": (c, 1), "M": (m, 1),
                        "S": (0, 1)}, 1, 0, plane)

    path = work / "slide_scan.czi"
    xml = czi_metadata_xml({"X": READERS_SPACING, "Y": READERS_SPACING}, ["DAPI", "GFP"])
    file_bytes = write_czi(path, xml, subblocks())
    return path, truth, starts, file_bytes, time.perf_counter() - t0


def readers_mosaic(np, torch, tsi, tcore, tf, tstream, fuse, work, say, n=READERS_MOSAIC_N,
                   tile=READERS_MOSAIC_TILE, overlap=READERS_MOSAIC_OVERLAP,
                   window=READERS_WINDOW):
    """A CZI slide-scan mosaic through ``stitch()``: n x n tiles of tile^2
    uint16 in 2 channels cut from one band-limited image at their true grid
    positions, written as raw subblocks whose X/Y starts hold the true
    positions plus an integer error; opened lazily by
    ``io.read_mosaic_into_sims``, stitched on the card by channel 0, cold
    and warm. Held: every tile's registered offset within 0.25 px of the
    truth (after the global offset), the fused image bit-equal to
    ``stitch()`` of the same tiles held as numpy arrays, a centre window
    within 1 count of ``fuse(device="cpu")``; at least one launch of
    ``fuse_translation_2d``."""
    from multiview_stitcher_torch import io as tio
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch import residency
    from multiview_stitcher_torch import stitch as tstitch
    from multiview_stitcher_torch.io import czi_utils as tczi

    path, truth, starts, file_bytes, write_s = write_slide_scan(np, torch, work, n, tile,
                                                                overlap)
    sp = READERS_SPACING
    tol = {"y": READERS_MOSAIC_ERROR * sp, "x": READERS_MOSAIC_ERROR * sp}
    # shortest paths: the default global optimisation stops unconverged on
    # large grids (ROADMAP item 24); its error is printed beside
    rkw = {"reg_channel_index": 0, "overlap_tolerance": tol,
           "groupwise_resolution_method": "shortest_paths"}
    spans, graphs = {}, []

    def timed(module, name, counter):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            counter.stage = name
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[name] = (t, time.perf_counter())
            counter.stage = "other"
            return out

        setattr(module, name, wrapped)
        return fn

    resolve = treg.param_resolution.groupwise_resolution

    def keep_graph(g, **k):
        graphs.append(g)
        return resolve(g, **k)

    def run(sims):
        tcore.clear_device_tile_cache()
        msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in sims]
        with ReadCounter(tczi) as counter:
            saved = (timed(tstitch.registration, "register", counter),
                     timed(tstitch.fusion, "fuse", counter))
            treg.param_resolution.groupwise_resolution = keep_graph
            try:
                t = time.perf_counter()
                fused = tstitch.stitch(msims, transform_key=KEY, register_kwargs=rkw)
                torch.cuda.synchronize()
                t_end = time.perf_counter()
            finally:
                tstitch.registration.register, tstitch.fusion.fuse = saved
                treg.param_resolution.groupwise_resolution = resolve
        (r0, r1), (f0, f1) = spans["register"], spans["fuse"]
        spans.update(register_s=r1 - r0, fuse_s=f1 - f0, outside_s=(r0 - t) + (f0 - r1)
                     + (t_end - f1))
        return msims, fused, t_end - t, counter

    t0 = time.perf_counter()
    lazy = tio.read_mosaic_into_sims(path)
    open_cold_s = time.perf_counter() - t0
    if len(lazy) != n * n or not all(isinstance(s.data, tczi.LazyCziTile) for s in lazy):
        raise AssertionError(f"readers: {len(lazy)} lazy tiles read, {n * n} expected")
    _, cold, cold_s, _ = run(lazy)
    del cold
    # this path's run: counts set to 0 just before, read just after
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    uploaded = residency.tile_upload_bytes
    t0 = time.perf_counter()
    lazy = tio.read_mosaic_into_sims(path)
    open_s = time.perf_counter() - t0
    msims, fused, warm_s, counter = run(lazy)
    warm = dict(spans)
    launches = tf.fuse_translation_2d.launches
    reg_tel, stream = dict(treg.last_telemetry), dict(tstream.last_telemetry)
    tile_bytes = residency.tile_upload_bytes - uploaded
    if launches < 1 or tf.fuse_translation_3d.launches:
        raise AssertionError(f"readers: fuse_translation_2d launches {launches}, 3d "
                             f"{tf.fuse_translation_3d.launches}")

    # every pair's shift, and the registered offsets, against the truth
    # (after the global offset)
    pert = starts - truth
    g_pairs = graphs[-1]
    pair_err = max(
        float(np.abs(np.asarray(d["transform"].data)[:2, 2] / sp - (pert[v] - pert[u])).max())
        for u, v, d in g_pairs.edges(data=True))
    origins = np.asarray([[s.origin["y"], s.origin["x"]] for s in lazy])

    def offset_error(mats):
        placed = np.asarray([m[:2, :2] @ o + m[:2, 2] for m, o in zip(mats, origins)]) / sp
        err = placed - truth
        return float(np.abs(err - err.mean(axis=0)).max())

    offset_err = offset_error(
        [np.asarray(tmsi.get_transform_from_msim(m, "registered").data) for m in msims])
    global_params, _ = resolve(g_pairs, method="global_optimization")
    global_opt_err = offset_error([np.asarray(global_params[k].data) for k in range(len(lazy))])
    meta_err = float(np.abs(pert - pert.mean(axis=0)).max())
    if pair_err > READERS_OFFSET_ATOL or offset_err > READERS_OFFSET_ATOL:
        raise AssertionError(f"readers: pair shifts {pair_err:.3f} px, registered offsets "
                             f"{offset_err:.3f} px from the truth")

    # the same tiles as numpy arrays under the same metadata
    t0 = time.perf_counter()
    mem = [tsi.get_sim_from_array(np.asarray(s.data), dims=s.dims, scale=dict(s.spacing),
                                  translation=dict(s.origin), transform_key=KEY,
                                  c_coords=list(s.coords["c"])) for s in lazy]
    read_all_s = time.perf_counter() - t0
    _, ref, mem_s, _ = run(mem)
    if ref.data.shape != fused.data.shape or not np.array_equal(ref.data, fused.data):
        raise AssertionError("readers: stitch() of the lazy CZI differs from the in-memory tiles")
    del ref, mem

    # a centre window against the CPU
    out = fused.data
    osp = {"spacing": dict(fused.spacing), "origin": dict(fused.origin)}
    start = [(out.shape[1] - window) // 2, (out.shape[2] - window) // 2]
    props = window_props(osp, ["y", "x"], start, window)
    t0 = time.perf_counter()
    cpu = fuse([tmsi.get_sim_from_msim(m) for m in msims], transform_key="registered",
               output_stack_properties=props, device="cpu").data
    cpu_s = time.perf_counter() - t0
    win_err = general_window_err(
        np, out[:, start[0]:start[0] + window, start[1]:start[1] + window], cpu,
        "readers: CZI mosaic window")
    tcore.clear_device_tile_cache()

    split = {
        "open_s": open_s,
        "register_s": warm["register_s"],
        "graph_and_prune_s": reg_tel["graph_s"] + reg_tel["prune_s"],
        "crop_plan_s": reg_tel["plan_s"],
        "tile_upload_s": reg_tel["upload_s"],
        "pairwise_host_s": reg_tel["pairwise_s"],
        "pairwise_device_ms": reg_tel.get("pairwise_device_ms"),
        "resolve_s": reg_tel["resolve_s"],
        "fuse_s": warm["fuse_s"],
        "outside_register_and_fuse_s": warm["outside_s"],
        "memory_register_s": spans["register_s"],
        "memory_fuse_s": spans["fuse_s"],
        "register_read_s": counter.seconds.get("register", 0.0),
        "fuse_read_s": counter.seconds.get("fuse", 0.0),
    }
    read = {k: int(v) for k, v in counter.bytes.items()}
    say(f"CZI slide scan: {n} x {n} tiles of {tile}^2 uint16, 2 channels, overlap {overlap} px, "
        f"{sp} um pixels, stage positions off by up to {meta_err:.0f} px; file {file_bytes / 1e9:.3f}"
        f" GB of raw subblocks written in {write_s:.1f} s; opened lazily in {open_cold_s:.3f} s "
        f"cold, {open_s:.3f} s warm; output {out.shape} {out.dtype}")
    say(f"CZI slide scan: cold stitch {cold_s:.3f} s, warm stitch {warm_s:.3f} s (open "
        f"{open_s:.3f} s besides); the same tiles from memory {mem_s:.3f} s (read into memory "
        f"in {read_all_s:.2f} s); edges {reg_tel['edges']}, pairs {reg_tel['pruned_edges']}; "
        f"fuse_translation_2d launches {launches}")
    say("CZI slide scan: warm split " + json.dumps(
        {k: (None if v is None else round(v, 4)) for k, v in split.items()}))
    say(f"CZI slide scan: bytes read from the file by stage {read} ({sum(read.values()) / 1e9:.3f}"
        f" GB against a {file_bytes / 1e9:.3f} GB file: register reads channel 0, fuse reads "
        f"channel 0 for the output geometry and each channel to fuse it); tiles uploaded "
        f"{tile_bytes} bytes as device tile stacks, {stream.get('up_bytes')} bytes by the "
        f"streamed fuse of the last channel in {stream.get('bands_total')} bands")
    say(f"CZI slide scan: every pair's shift within {pair_err:.4f} px of the truth; offsets "
        f"resolved by shortest paths within {offset_err:.4f} px of the truth, by the default "
        f"global optimisation within {global_opt_err:.4f} px (not held: item 24); stitch() "
        f"bit-equal to "
        f"the in-memory tiles'; the centre {window}^2 window within {win_err} counts of "
        f"device='cpu' ({cpu_s:.1f} s)")
    return {"launches": int(launches), "file_bytes": file_bytes, "write_s": write_s,
            "open_cold_s": open_cold_s, "cold_stitch_s": cold_s, "warm_stitch_s": warm_s,
            "memory_stitch_s": mem_s, **split, "read_bytes": read, "tile_upload_bytes": tile_bytes,
            "stream": stream, "edges": reg_tel["edges"], "pairs": reg_tel["pruned_edges"],
            "pair_max_err_px": pair_err, "offset_max_err_px": offset_err,
            "global_opt_offset_max_err_px": global_opt_err, "window_max_err": win_err}


def readers_multiview(np, torch, tsi, tcore, tf, tea, fuse, work, say, shape=READERS_MV_SHAPE,
                      angles=READERS_MV_ANGLES, window=READERS_MV_WINDOW, chunk=128):
    """A multi-view CZI in a Lightsheet Z.1 layout: views of one smooth
    volume with ``View`` positions (the volume's centre) and angles,
    read by ``read_multiview_czi_into_sims`` under the default
    ``rotate_around_y_positions``, fused on the card cold and warm through
    the exact-affine tier. Held: the output bit-equal to ``fuse()`` of the
    same arrays from memory under the affines the reader returned, a central
    window within 1 count of ``device="cpu"``; at least one launch of
    ``exact_affine_3d_sepy``."""
    from multiview_stitcher_torch.io import czi_utils as tczi

    rng = np.random.default_rng(24)
    t0 = time.perf_counter()
    base = smooth_tile(np, rng, tuple(s // 4 for s in shape))
    for axis in range(3):
        base = np.repeat(base, 4, axis=axis)
    centre = [(s - 1) / 2 for s in shape]  # z, y, x in um (1 um voxels)
    views = [(centre[2], centre[1], centre[0], float(a)) for a in angles]
    data = [np.ascontiguousarray(np.roll(base, 37 * iv, axis=2)) for iv in range(len(angles))]

    def subblocks():
        for v, vol in enumerate(data):
            for z in range(shape[0]):
                yield ({"X": (0, shape[2]), "Y": (0, shape[1]), "C": (0, 1), "Z": (z, 1),
                        "M": (0, 1), "S": (0, 1), "V": (v, 1)}, 1, 0, vol[z])

    path = work / "multiview.czi"
    xml = czi_metadata_xml({"X": 1.0, "Y": 1.0, "Z": 1.0}, ["Ch0"], views=views)
    file_bytes = write_czi(path, xml, subblocks())
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sims = tczi.read_multiview_czi_into_sims(path)
    read_s = time.perf_counter() - t0
    for s, v in zip(sims, data):
        if not np.array_equal(np.asarray(s.data)[0], v):
            raise AssertionError("readers: a multi-view CZI view differs from what was written")
    names = {"2d": EXACT_WRAPPERS[0], "sepy": EXACT_WRAPPERS[1], "general": EXACT_WRAPPERS[2]}

    def counts():
        return {k: getattr(tea, n).launches for k, n in names.items()}

    t0 = time.perf_counter()
    cold = fuse(sims, transform_key=KEY, output_chunksize=chunk)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del cold
    tcore.clear_device_tile_cache()
    for n in names.values():
        getattr(tea, n).launches = 0
    tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
    with StageTimer(torch, tcore, tf, tea) as st:
        t0 = time.perf_counter()
        fused = fuse(sims, transform_key=KEY, output_chunksize=chunk)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split = st.split_ms(t0, t1)
    warm_s = t1 - t0
    launched = counts()
    if launched["sepy"] < 1 or launched["general"] or launched["2d"]:
        raise AssertionError(f"readers: multi-view launches {launched}, expected the sepy kernel")

    mem = []
    for s in sims:
        m = tsi.get_sim_from_array(np.array(s.data), dims=s.dims, scale=dict(s.spacing),
                                   translation=dict(s.origin), c_coords=list(s.coords["c"]))
        tsi.set_sim_affine(m, s.transforms[KEY].data, transform_key=KEY)
        mem.append(m)
    ref = fuse(mem, transform_key=KEY, output_chunksize=chunk).data
    out = fused.data
    if ref.shape != out.shape or not np.array_equal(ref, out):
        raise AssertionError("readers: the multi-view CZI's fuse differs from the in-memory one")
    del ref, mem
    sdims = ["z", "y", "x"]
    osp = {"spacing": dict(fused.spacing), "origin": dict(fused.origin)}
    start = [(out.shape[-3 + i] - window) // 2 // chunk * chunk for i in range(3)]
    t0 = time.perf_counter()
    cpu = fuse(sims, transform_key=KEY, output_chunksize=chunk, device="cpu",
               output_stack_properties=window_props(osp, sdims, start, window)).data
    cpu_s = time.perf_counter() - t0
    win = out[(Ellipsis,) + tuple(slice(a, a + window) for a in start)]
    win_err = general_window_err(np, win, cpu, "readers: multi-view window")
    tcore.clear_device_tile_cache()
    angles_read = [float(np.rad2deg(np.arctan2(s.transforms[KEY].data[0, 2],
                                               s.transforms[KEY].data[0, 0]))) for s in sims]
    say(f"multi-view CZI: {len(angles)} views of {shape} uint16 at {list(angles)} degrees about "
        f"y, file {file_bytes / 1e9:.3f} GB written in {write_s:.1f} s, read in {read_s:.2f} s; "
        f"affines' angles {[round(a, 6) for a in angles_read]}; output {out.shape} {out.dtype}")
    say(f"multi-view CZI: cold fuse {cold_s:.3f} s, warm fuse {warm_s:.3f} s, launches "
        f"{launched}; warm split " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    say(f"multi-view CZI: bit-equal to fuse() from memory; central {window}^3 window within "
        f"{win_err} counts of device='cpu' ({cpu_s:.1f} s)")
    return {"launches": launched, "file_bytes": file_bytes, "write_s": write_s, "read_s": read_s,
            "cold_fuse_s": cold_s, "warm_fuse_s": warm_s, "split_ms": split,
            "window_max_err": win_err}


def readers_tiff_grid(np, torch, tsi, tcore, tf, tstream, fuse, work, say, n=READERS_TIFF_N,
                      tile=READERS_TIFF_TILE, overlap=READERS_TIFF_OVERLAP, chunk=128):
    """A 3D tile grid of deflate TIFFs (z pages) written by the port's
    ``write_tiff``, opened lazily by ``read_tiff_into_sim(path,
    translation=...)`` and fused into an OME-Zarr with
    ``output_chunksize=128`` through the streaming tier, cold and warm.
    Held: level 0 bit-equal to the same tiles fused from memory into an
    OME-Zarr of their own; a chunk-aligned window across the central tiles'
    overlaps (all z, 2 chunks in y and x) within 1 count of the same lazy
    tiles fused with ``device="cpu"``, the plain versions; at least one
    launch of ``fuse_translation_3d``."""
    from multiview_stitcher_torch.io import tif_utils as ttif
    from multiview_stitcher_torch.io import zarr_backend

    step = tile[1] - overlap
    extent = (n - 1) * step + tile[1]
    t0 = time.perf_counter()
    vol = smooth_noise(torch, (tile[0], extent, extent), seed=25, device="cuda")
    jobs = []
    for iy in range(n):
        for ix in range(n):
            data = np.ascontiguousarray(vol[:, iy * step:iy * step + tile[1],
                                            ix * step:ix * step + tile[2]])
            jobs.append((work / f"tile_{iy}_{ix}.tif", data,
                         {"z": 0.0, "y": float(iy * step), "x": float(ix * step)}))
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda j: ttif.write_tiff(j[0], j[1], compression="deflate"), jobs))
    write_s = time.perf_counter() - t0
    del vol
    file_bytes = sum(j[0].stat().st_size for j in jobs)
    tile_bytes = sum(j[1].nbytes for j in jobs)
    runs = {}
    for run in ("cold", "warm"):
        url = str(work / f"tiff_grid_{run}.ome.zarr")
        tf.fuse_translation_2d.launches = tf.fuse_translation_3d.launches = 0
        t0 = time.perf_counter()
        sims = [ttif.read_tiff_into_sim(p, translation=t) for p, _, t in jobs]
        open_s = time.perf_counter() - t0
        if not all(isinstance(s.data, ttif.LazyTiffPagesND) for s in sims):
            raise AssertionError("readers: the TIFF tiles were not read lazily")
        t0 = time.perf_counter()
        res = fuse(sims, transform_key=KEY, output_chunksize=chunk, output_zarr_url=url)
        torch.cuda.synchronize()
        runs[run] = {"open_s": open_s, "wall_s": time.perf_counter() - t0,
                     **tstream.last_telemetry}
    launches = tf.fuse_translation_3d.launches
    tele = runs["warm"]
    if launches < 1 or tf.fuse_translation_2d.launches or tele["bands_done"] != launches:
        raise AssertionError(f"readers: TIFF grid launches {launches}, streaming {tele}")
    mem = [tsi.get_sim_from_array(d, dims=["z", "y", "x"], translation=t) for _, d, t in jobs]
    mem_url = str(work / "tiff_grid_memory.ome.zarr")
    t0 = time.perf_counter()
    fuse(mem, transform_key=KEY, output_chunksize=chunk, output_zarr_url=mem_url)
    mem_s = time.perf_counter() - t0
    level0 = np.asarray(zarr_backend.open_zarr_array(str(work / "tiff_grid_warm.ome.zarr") + "/0"))
    ref0 = np.asarray(zarr_backend.open_zarr_array(mem_url + "/0"))
    if level0.shape != ref0.shape or not np.array_equal(level0, ref0):
        raise AssertionError("readers: the TIFF grid's level 0 differs from the in-memory fuse")
    del ref0
    # the kernel against its plain versions at these tile shapes: a window
    # of the same lazy tiles fused on the CPU
    sdims = ["z", "y", "x"]
    osp = {"spacing": dict(res.spacing), "origin": dict(res.origin)}
    size = [level0.shape[-3]] + [min(2 * chunk, s) for s in level0.shape[-2:]]
    start = [0] + [(s - w) // 2 // chunk * chunk for s, w in zip(level0.shape[-2:], size[1:])]
    t0 = time.perf_counter()
    cpu = fuse(sims, transform_key=KEY, output_chunksize=chunk, device="cpu",
               output_stack_properties=window_props(osp, sdims, start, size)).data
    cpu_s = time.perf_counter() - t0
    win = level0[(Ellipsis,) + tuple(slice(a, a + w) for a, w in zip(start, size))]
    win_err = general_window_err(np, win, np.asarray(cpu), "readers: TIFF grid window")
    del cpu, win
    say(f"TIFF grid: {n} x {n} deflate TIFFs of {tile} uint16, overlap {overlap}, "
        f"{tile_bytes / 1e6:.0f} MB of tiles in {file_bytes / 1e6:.0f} MB of files written in "
        f"{write_s:.1f} s; level 0 {level0.shape} {level0.dtype}")
    for run, r in runs.items():
        say(f"TIFF grid {run}: open {r['open_s'] * 1e3:.1f} ms, fuse into OME-Zarr "
            f"{r['wall_s']:.3f} s ({tile_bytes / 1e6 / r['wall_s']:.0f} MB/s of tiles read and "
            f"fused), streaming {r['elapsed_s'] * 1e3:.1f} ms, bands {r['bands_total']}, NV "
            f"{r['nv']}, up {r['up_bytes'] / 1e6:.1f} MB, stream spans ms "
            + " ".join(f"{k} {r[k + '_ms']}" for k in ("up", "compute", "down")))
    say(f"TIFF grid: fuse_translation_3d launches {launches}; level 0 bit-equal to the "
        f"in-memory tiles' fuse ({mem_s:.3f} s); window {size} at {start} within {win_err} "
        f"counts of device='cpu' ({cpu_s:.1f} s)")
    return {"launches": int(launches), "write_s": write_s, "file_bytes": file_bytes,
            "tile_bytes": tile_bytes, "memory_fuse_s": mem_s, "window_max_err": win_err,
            **{run: r for run, r in runs.items()}}


def readers_optional(np, say, found, work):
    """The readers that need an optional package, on small files: a ZSTD1
    hi/lo CZI mosaic (zstandard), an Imaris file (h5py), a PNG (imageio /
    PIL). Where the package is absent, the reader must raise as the JAX
    package's does, and the case is reported as not run."""
    from multiview_stitcher_torch import io as tio
    from multiview_stitcher_torch.io import czi_utils as tczi

    rng = np.random.default_rng(26)
    img = rng.integers(0, 4000, (2, 64, 80), dtype=np.uint16)
    results = {}

    def case(name, needs, run, absent_error):
        if all(found.get(m) for m in needs):
            run()
            results[name] = "ran"
        else:
            missing = [m for m in needs if not found.get(m)]
            results[name] = f"not run: {', '.join(missing)} absent"
            if absent_error is not None:
                try:
                    absent_error()
                except (ImportError, NotImplementedError):
                    pass
                else:
                    raise AssertionError(f"readers: {name} did not raise without {missing}")

    def zstd_run():
        import zstandard

        path = work / "zstd.czi"
        planes = []
        for c in range(2):
            raw = img[c].tobytes()
            # ZSTD1 with the hi/lo byte planes of 16-bit data
            payload = bytes([3, 1, 1]) + zstandard.ZstdCompressor().compress(raw[0::2] + raw[1::2])
            planes.append(({"X": (0, img.shape[2]), "Y": (0, img.shape[1]), "C": (c, 1),
                            "M": (0, 1), "S": (0, 1)}, 1, 6, payload))
        write_czi(path, czi_metadata_xml({"X": 1.0, "Y": 1.0}, ["a", "b"]), planes)
        (sim,) = tio.read_mosaic_into_sims(path)
        if not np.array_equal(np.asarray(sim.data), img):
            raise AssertionError("readers: the ZSTD1 CZI differs from what was written")

    def zstd_absent():
        tczi._decompress_subblock(b"\x01", 6, np.uint16)

    def ims_run():
        import h5py

        path = work / "small.ims"
        with h5py.File(path, "w") as f:
            g = f.create_group("DataSet/ResolutionLevel 0/TimePoint 0/Channel 0")
            g.create_dataset("Data", data=img[0][None])
            for d, s in zip("ZYX", (1,) + img.shape[1:]):
                g.attrs[f"ImageSize{d}"] = np.bytes_(str(s))
            info = f.create_group("DataSetInfo/Image")
            for i, (d, s) in enumerate(zip("XYZ", img.shape[:0:-1] + (1,))):
                info.attrs[d] = np.bytes_(str(s))
                info.attrs[f"ExtMin{i}"] = np.bytes_("0")
                info.attrs[f"ExtMax{i}"] = np.bytes_(str(s))
        (sim,) = tio.read_mosaic_into_sims(path)
        if not np.array_equal(np.asarray(sim.data)[0], img[0]):
            raise AssertionError("readers: the Imaris file differs from what was written")

    def ims_absent():
        import importlib

        importlib.import_module("multiview_stitcher_torch.io.imaris_utils")

    def png_run():
        from PIL import Image

        path = work / "small.png"
        Image.fromarray((img[0] >> 4).astype(np.uint8)).save(path)
        (sim,) = tio.read_mosaic_into_sims(path)
        if not np.array_equal(np.asarray(sim.data), (img[0] >> 4).astype(np.uint8)):
            raise AssertionError("readers: the PNG differs from what was written")

    def png_absent():
        path = work / "absent.png"
        path.write_bytes(b"\x89PNG")
        tio.read_mosaic_into_sims(path)

    case("czi_zstd1", ("zstandard",), zstd_run, zstd_absent)
    case("imaris", ("h5py",), ims_run, ims_absent)
    case("png", ("imageio", "PIL"), png_run, png_absent if not found.get("imageio") else None)
    say("optional formats: " + json.dumps(results))
    return results


def readers_phase(np, torch, tsi, tcore, tf, tea, tstream, fuse, work, found, scale=1):
    """``readers:`` lines: the user's files through the port's readers to
    ``stitch()`` and ``fuse()`` on the card (the codecs, a CZI slide scan, a
    multi-view CZI, a TIFF tile grid, the optional formats). The files live
    under ``work``, removed after. ``scale`` divides the sizes (1 on the
    card). Returns the results and the launches of each kernel in the
    phase's reader-driven warm calls."""
    card = card_line()

    def say(msg):
        log(f"{card} readers: {msg}")

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        codec = readers_codecs(
            np, torch, say, shape=tuple(s // scale for s in READERS_CODEC_SHAPE),
            deflate_shape=tuple(s // scale for s in READERS_DEFLATE_SHAPE))
        mosaic = readers_mosaic(
            np, torch, tsi, tcore, tf, tstream, fuse, work, say,
            n=max(3, READERS_MOSAIC_N // scale), tile=READERS_MOSAIC_TILE // scale,
            overlap=READERS_MOSAIC_OVERLAP // scale, window=READERS_WINDOW // scale)
        torch.cuda.empty_cache()
        multiview = readers_multiview(
            np, torch, tsi, tcore, tf, tea, fuse, work, say,
            shape=tuple(s // scale for s in READERS_MV_SHAPE),
            window=READERS_MV_WINDOW // scale, chunk=128 // scale)
        torch.cuda.empty_cache()
        tiff = readers_tiff_grid(
            np, torch, tsi, tcore, tf, tstream, fuse, work, say,
            tile=(READERS_TIFF_TILE[0] // min(scale, 4),) + tuple(
                s // scale for s in READERS_TIFF_TILE[1:]),
            overlap=READERS_TIFF_OVERLAP // scale, chunk=128 // scale)
        optional = readers_optional(np, say, found, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {"fuse_translation_3d": tiff["launches"],
                "fuse_translation_2d": mosaic["launches"],
                "exact_affine_batch_2d": multiview["launches"]["2d"],
                "exact_affine_batch_3d_sepy": multiview["launches"]["sepy"],
                "exact_affine_batch_3d_general": multiview["launches"]["general"]}
    phase_s = time.perf_counter() - t_phase
    say(f"phase {phase_s:.1f} s; launches on data the readers delivered {json.dumps(launches)}")
    return {"codecs": codec, "czi_mosaic": mosaic, "czi_multiview": multiview,
            "tiff_grid": tiff, "optional": optional, "phase_s": phase_s}, launches


# ---------------------------------------------------------------------------
# the service phase: a session serving the slide scan, workers over bridges
# ---------------------------------------------------------------------------

# output blocks of the scan's fuse_to_zarr: 4 blocks (2 x 2) of the
# (14854, 14854) output; each block reads every tile of both channels (ROADMAP
# item 35), so 2048^2 blocks (64) read 104 GB and took 175.6 s (PERF.md, PR 16)
SERVICE_CHUNK = 8192
# the corner's blocks: 4 of them (3790^2 output), two a worker
SERVICE_CORNER_CHUNK = 2048
SERVICE_CORNER = 4
SERVICE_WORKERS = 2
SERVICE_HTTP_REPS = 20
SERVICE_VIEWS = 4
SERVICE_BRIDGE_ATOL = 1e-3
SERVICE_WORKER_TIMEOUT_S = 300


def service_worker_probe(barrier):
    """Run in a worker of a ``ProcessPoolBridge``: its pid, its runtime's
    device and card, and the launches of each kernel in the process so far.
    Waits on ``barrier`` so that each worker of the pool answers once."""
    import torch

    from multiview_stitcher_torch.ops import exact_affine as tea
    from multiview_stitcher_torch.ops import translation_fusion as tf
    from multiview_stitcher_torch.service import bridge

    barrier.wait(timeout=SERVICE_WORKER_TIMEOUT_S)
    device = bridge._POOL_RUNTIME.device
    launches = {"fuse_translation_3d": tf.fuse_translation_3d.launches,
                "fuse_translation_2d": tf.fuse_translation_2d.launches,
                **{name: getattr(tea, name).launches for name in EXACT_WRAPPERS}}
    return {"pid": os.getpid(), "device": str(device),
            "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
            "launches": launches}


def probe_workers(bridge, ctx, n):
    """One :func:`service_worker_probe` answer from each of the ``n``
    workers of ``bridge`` (a barrier of ``n`` makes each worker take one)."""
    with ctx.Manager() as manager:
        barrier = manager.Barrier(n)
        futures = [bridge._pool.submit(service_worker_probe, barrier) for _ in range(n)]
        answers = [f.result(timeout=SERVICE_WORKER_TIMEOUT_S) for f in futures]
    if len({a["pid"] for a in answers}) != n:
        raise AssertionError(f"service: {n} workers expected, answers {answers}")
    return answers


def http_get(url) -> tuple:
    """The bytes of a GET and its seconds."""
    import urllib.request

    t = time.perf_counter()
    with urllib.request.urlopen(url, timeout=60) as r:
        data = r.read()
    return data, time.perf_counter() - t


def latency(np, seconds) -> dict:
    return {"median_ms": float(np.median(seconds) * 1e3),
            "p95_ms": float(np.percentile(seconds, 95) * 1e3), "n": len(seconds)}


def padded_chunk(np, arr, idx, chunks):
    """The zarr chunk ``idx`` of ``arr``, zero-padded to ``chunks``."""
    sl = tuple(slice(i * c, min((i + 1) * c, n)) for i, c, n in zip(idx, chunks, arr.shape))
    out = np.zeros(chunks, arr.dtype)
    block = arr[sl]
    out[tuple(slice(0, b) for b in block.shape)] = block
    return out


def service_phase(np, torch, tsi, tcore, tf, tea, fuse, work, scale=1):
    """``service:`` lines: the service runtime on the card, through its
    default device, over the ``readers:`` phase's CZI slide scan (written
    again here under ``work``, removed after). In process: a ``Session``
    loads the 256 views, registers them by channel 0 (shortest paths), fuses
    a preview and serves it and the views over HTTP (loopback), read back
    through the port's ``zarr_backend`` HTTP read; a virtual store over
    ``fuse(..., output_on_backend=True)`` serves its chunks from the card;
    the neuroglancer state and fusion plan; ``fuse_to_zarr`` block by block.
    Over bridges, on the scan's 4 x 4 corner: ``register`` over a
    ``LocalBridge`` against the in-process call, ``fuse_to_zarr`` over a
    ``ProcessPoolBridge`` of two spawned workers on the card, byte-equal to
    the in-process store. Returns the results and each kernel's launches in
    the phase."""
    import multiprocessing as mp

    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch.utils import misc as tmisc
    from multiview_stitcher_torch.io import czi_utils as tczi
    from multiview_stitcher_torch.io import virtual_ngff as tvn
    from multiview_stitcher_torch.io import zarr_backend as tzb
    from multiview_stitcher_torch.parallel.executors import SourceSpec
    from multiview_stitcher_torch.service import (
        FusionOptions,
        LocalBridge,
        ProcessPoolBridge,
        RegistrationOptions,
        Session,
    )

    card = card_line()
    # the port's default device, which no call of this phase names: the card
    device = tmisc.resolve_device(None)

    def say(msg):
        log(f"{card} service: {msg}")

    def synced(fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    n = max(SERVICE_CORNER, READERS_MOSAIC_N // scale)
    tile, overlap = READERS_MOSAIC_TILE // scale, READERS_MOSAIC_OVERLAP // scale
    chunk, corner_chunk = SERVICE_CHUNK // scale, SERVICE_CORNER_CHUNK // scale
    sp = READERS_SPACING
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        path, truth, starts, file_bytes, write_s = write_slide_scan(np, torch, work, n, tile,
                                                                    overlap)
        # this phase's run: counts set to 0 just before, read just after
        for name in KERNEL_NAMES:
            getattr(tf if name.startswith("fuse_") else tea, name).launches = 0
        # shortest paths (ROADMAP item 24) at a 0.01 px grid: the session's
        # JSON options carry no overlap tolerance, so a pair's crops miss up
        # to the stage error of their overlap, and the default 0.1 px grid
        # leaves the offsets above the 0.25 px this phase holds
        reg_opts = RegistrationOptions(new_transform_key="registered",
                                       groupwise_resolution_method="shortest_paths",
                                       pairwise_reg_func_kwargs={"upsample_factor": 100})
        fuse_opts = FusionOptions(transform_key="registered", output_chunksize=chunk)

        # -- in process: load, register, preview; cold, then warm ----------
        say(f"slide scan {n} x {n} tiles of {tile}^2 uint16, 2 channels: {file_bytes / 1e9:.3f}"
            f" GB of CZI written in {write_s:.1f} s; sessions on {device}")
        counter = ReadCounter(tczi)
        runs = []
        with counter:
            for label in ("cold", "warm"):
                t0 = time.perf_counter()
                counter.stage = "load"
                session = Session()
                views = session.load_mosaic(str(path))
                load_s = time.perf_counter() - t0
                counter.stage = "register"
                summary, reg_s = synced(session.register, reg_opts)
                counter.stage = "preview"
                preview, preview_s = synced(session.fuse_preview)
                runs.append({"load_s": load_s, "register_s": reg_s, "preview_s": preview_s,
                             "first_preview_s": time.perf_counter() - t0})
                say(f"{label}: load_mosaic {load_s:.3f} s, register {reg_s:.3f} s, fuse_preview "
                    f"{preview_s:.3f} s, the first preview {runs[-1]['first_preview_s']:.3f} s "
                    "after Session()")
            counter.stage = "other"
            if len(views) != n * n or session.device != device:
                raise AssertionError(f"service: {len(views)} views on {session.device}")
            described = session.describe()
            spec_json = session.spec().to_json()
            rebuilt, from_spec_s = synced(Session.from_spec, spec_json)
            if rebuilt.spec().to_json() != spec_json or rebuilt.describe() != described:
                raise AssertionError("service: from_spec() does not give the session back")
            del rebuilt

            # every view's registered offset against the truth (after the
            # global offset)
            origins = np.asarray([[v["origin"]["y"], v["origin"]["x"]] for v in described])
            placed = np.asarray([np.asarray(p)[:2, :2] @ o + np.asarray(p)[:2, 2]
                                 for p, o in zip(summary["params"], origins)]) / sp
            err = placed - truth
            offset_err = float(np.abs(err - err.mean(axis=0)).max())
            say(f"from_spec {from_spec_s:.3f} s (every view reopens the CZI); offsets by "
                f"shortest paths within {offset_err:.4f} px of the truth; preview "
                f"{preview['shape']} at spacing {preview['spacing']}")
            if offset_err > READERS_OFFSET_ATOL:
                raise AssertionError(f"service: registered offsets {offset_err:.3f} px from "
                                     "the truth")

            # -- serve: the preview and four views over HTTP --------------
            counter.stage = "serve"
            info = session.serve(port=free_port())
            try:
                base, route = info["base_url"], preview["route"]
                if route not in info["routes"] or len(info["routes"]) != n * n + 1:
                    raise AssertionError(f"service: routes {info['routes'][:3]}...")
                pstore = session.preview_store(route)
                pdata = np.asarray(pstore.msim.sims[0].data)
                got = tzb.open_zarr_array(f"{base}/{route}/0")
                if not np.array_equal(np.asarray(got), pdata):
                    raise AssertionError("service: the preview over HTTP differs from its sim")
                pmeta = json.loads(pstore.get("0/.zarray"))
                pgrid = [-(-s // c) for s, c in zip(pmeta["shape"], pmeta["chunks"])]
                preview_lat = []
                for idx in np.ndindex(*pgrid):
                    key = ".".join(map(str, idx))
                    for rep in range(SERVICE_HTTP_REPS):
                        raw, dt = http_get(f"{base}/{route}/0/{key}")
                        preview_lat.append(dt)
                    if raw != padded_chunk(np, pdata, idx, pmeta["chunks"]).tobytes():
                        raise AssertionError(f"service: preview chunk {key} differs")
                view_ids = np.linspace(0, n * n - 1, SERVICE_VIEWS).round().astype(int)
                view_lat = []
                for v in view_ids:
                    pixels = tmsi.get_sim_from_msim(session.msims[v]).to_numpy()
                    vmeta = json.loads(http_get(f"{base}/{v}.ome.zarr/0/.zarray")[0])
                    key = ".".join("0" for _ in vmeta["shape"])
                    for rep in range(SERVICE_HTTP_REPS):
                        raw, dt = http_get(f"{base}/{v}.ome.zarr/0/{key}")
                        view_lat.append(dt)
                    ref = padded_chunk(np, pixels, (0,) * pixels.ndim, vmeta["chunks"])
                    if raw != ref.tobytes():
                        raise AssertionError(f"service: view {v}'s chunk {key} differs")
                state = session.neuroglancer_state(base_url=base)
                if len(state["layers"]) != n * n or not state["layers"][-1]["source"][
                        "url"].startswith(f"zarr://{base}/"):
                    raise AssertionError("service: the neuroglancer state misses views")
            finally:
                session.stop_serving()
            say(f"HTTP chunk requests (loopback, {SERVICE_HTTP_REPS} each): preview "
                + json.dumps(latency(np, preview_lat)) + f" over {int(np.prod(pgrid))} chunks, "
                "view " + json.dumps(latency(np, view_lat)) + f" over {len(view_ids)} views; "
                "every chunk bit-equal to its sim; the neuroglancer state names every view")
            counter.stage = "plan"
            plan, plan_s = synced(session.fusion_plan, fuse_opts)

            # -- a virtual store over the fused scan on the card -----------
            counter.stage = "fuse"
            sims = [tmsi.get_sim_from_msim(m) for m in session.msims]
            fused, fuse_s = synced(fuse, sims, transform_key="registered",
                                   output_on_backend=True)
            if not (isinstance(fused.data, torch.Tensor)
                    and fused.data.device.type == device.type):
                raise AssertionError("service: fuse(output_on_backend=True) is not on the card")
            host = fused.to_numpy()
            dstore = tvn.VirtualOMEZarr(fused)
            dmeta = json.loads(dstore.get("0/.zarray"))
            dgrid = [-(-s // c) for s, c in zip(dmeta["shape"], dmeta["chunks"])]
            card_lat = []
            for idx in np.ndindex(*dgrid):
                raw, dt = synced(dstore.get, "0/" + ".".join(map(str, idx)))
                card_lat.append(dt)
                if raw != padded_chunk(np, host, idx, dmeta["chunks"]).tobytes():
                    raise AssertionError(f"service: chunk {idx} from the card differs")
            server = tvn.VirtualOMEZarrServer({"fused.ome.zarr": dstore},
                                              port=free_port()).start()
            try:
                card_http = []
                for rep in range(SERVICE_HTTP_REPS):
                    raw, dt = http_get(f"{server.base_url}/fused.ome.zarr/0/0.0.0")
                    card_http.append(dt)
                if raw != padded_chunk(np, host, (0, 0, 0), dmeta["chunks"]).tobytes():
                    raise AssertionError("service: a card chunk over HTTP differs")
            finally:
                server.shutdown()
            del fused, dstore
            torch.cuda.empty_cache()
            say(f"fusion_plan {plan_s:.3f} s; fuse(output_on_backend=True) {fuse_s:.3f} s, "
                f"{tuple(dmeta['shape'])}; its {len(card_lat)} chunks served from the card "
                + json.dumps(latency(np, card_lat)) + ", one over HTTP "
                + json.dumps(latency(np, card_http)) + "; bit-equal to the output downloaded")

            # -- fuse_to_zarr in process, block by block --------------------
            counter.stage = "fuse_to_zarr"
            url = str(work / "fused.zarr")
            written, zarr_s = synced(session.fuse_to_zarr, url, fuse_opts)
            if written != {"n_blocks": plan["n_blocks"], "written": plan["n_blocks"]}:
                raise AssertionError(f"service: fuse_to_zarr wrote {written}, plan {plan}")
            level0 = np.asarray(tzb.open_zarr_array(url))
            if level0.shape != host.shape:
                raise AssertionError(f"service: fuse_to_zarr {level0.shape}, fuse {host.shape}")
            zarr_err = int(np.abs(level0.astype(np.int32) - host.astype(np.int32)).max())
            read = {k: int(v) for k, v in counter.bytes.items()}
            say(f"fuse_to_zarr in process: {plan['n_blocks']} blocks of {chunk}^2 in "
                f"{zarr_s:.3f} s, within {zarr_err} counts of fuse(); bytes read from the CZI "
                f"by step {json.dumps(read)} ({sum(read.values()) / 1e9:.3f} GB, file "
                f"{file_bytes / 1e9:.3f} GB)")
            if zarr_err > 1:
                raise AssertionError(f"service: fuse_to_zarr {zarr_err} counts from fuse()")
            del level0, host, session
            shutil.rmtree(url)

        # -- over bridges, on the scan's corner -----------------------------
        # the default options: the bridge registers each pair alone and the
        # session in batches, which share their 0.1 px grid
        corner_opts = RegistrationOptions(new_transform_key="registered")
        corner = [iy * n + ix for iy in range(SERVICE_CORNER) for ix in range(SERVICE_CORNER)]
        sources = [SourceSpec(url=str(path), view_index=int(m)) for m in corner]
        local = Session()
        local.load(sources)
        r_local, corner_reg_s = synced(local.register, corner_opts)
        bridged = Session()
        bridged.load(sources)
        r_bridge, bridge_reg_s = synced(bridged.register, corner_opts, bridge=LocalBridge())
        reg_diff = float(np.abs(np.asarray(r_bridge["params"])
                                - np.asarray(r_local["params"])).max())
        say(f"corner {SERVICE_CORNER} x {SERVICE_CORNER}: register {corner_reg_s:.3f} s in "
            f"process, {bridge_reg_s:.3f} s over a LocalBridge, {reg_diff:.2e} px apart")
        if reg_diff > SERVICE_BRIDGE_ATOL or r_bridge["edges"] != r_local["edges"]:
            raise AssertionError(f"service: LocalBridge register {reg_diff} px from in-process")
        copts = FusionOptions(transform_key="registered", output_chunksize=corner_chunk)
        url_local, url_pool = str(work / "corner_local.zarr"), str(work / "corner_pool.zarr")
        local_zarr, corner_zarr_s = synced(local.fuse_to_zarr, url_local, copts)
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        pool = ProcessPoolBridge(n_workers=SERVICE_WORKERS)
        try:
            started = probe_workers(pool, ctx, SERVICE_WORKERS)
            startup_s = time.perf_counter() - t0
            pool_zarr, pool_zarr_s = synced(
                local.fuse_to_zarr, url_pool, copts, bridge=pool,
                batch_size=max(1, -(-local_zarr["n_blocks"] // SERVICE_WORKERS)))
            after = probe_workers(pool, ctx, SERVICE_WORKERS)
        finally:
            pool.close()
        say(f"corner: fuse_to_zarr {corner_zarr_s:.3f} s in process ({local_zarr['n_blocks']} "
            f"blocks), {pool_zarr_s:.3f} s over a ProcessPoolBridge of {SERVICE_WORKERS} "
            f"workers (start-up, spawn to every worker's first answer, {startup_s:.3f} s); the "
            f"workers {json.dumps(after)}")
        if any(a["device"] != str(device) or (device.type == "cuda" and a["card"] is None)
               for a in started + after):
            raise AssertionError(f"service: workers not on the card {started}")
        worker_launches = sum(a["launches"]["fuse_translation_2d"] for a in after)
        if pool_zarr != local_zarr or worker_launches < 1:
            raise AssertionError(f"service: bridged {pool_zarr} against {local_zarr}, "
                                 f"{worker_launches} kernel 2 launches in the workers")
        files = sorted(p.name for p in Path(url_local).iterdir())
        if files != sorted(p.name for p in Path(url_pool).iterdir()) or any(
                (Path(url_local) / f).read_bytes() != (Path(url_pool) / f).read_bytes()
                for f in files):
            raise AssertionError("service: the bridged store differs from the in-process one")
        del local, bridged
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {name: getattr(tf if name.startswith("fuse_") else tea, name).launches
                for name in KERNEL_NAMES}
    if launches["fuse_translation_2d"] < 1:
        raise AssertionError(f"service: kernel 2 was not launched {launches}")
    phase_s = time.perf_counter() - t_phase
    res = {
        "views": n * n, "file_bytes": file_bytes, "write_s": write_s, "cold": runs[0],
        "warm": runs[1], "from_spec_s": from_spec_s, "offset_max_err_px": offset_err,
        "preview": {"shape": preview["shape"], "spacing": preview["spacing"]},
        "preview_chunk_http": latency(np, preview_lat), "view_chunk_http": latency(np, view_lat),
        "card_chunk": latency(np, card_lat), "card_chunk_http": latency(np, card_http),
        "fusion_plan_s": plan_s, "fuse_on_card_s": fuse_s, "plan": plan,
        "fuse_to_zarr_s": zarr_s, "fuse_to_zarr_max_err": zarr_err, "read_bytes": read,
        "corner": {"views": len(corner), "register_s": corner_reg_s,
                   "local_bridge_register_s": bridge_reg_s, "register_max_diff_px": reg_diff,
                   "fuse_to_zarr_s": corner_zarr_s, "blocks": local_zarr["n_blocks"],
                   "worker_startup_s": startup_s, "bridged_fuse_to_zarr_s": pool_zarr_s,
                   "workers": after},
        "launches": launches, "phase_s": phase_s,
    }
    say(f"phase {phase_s:.1f} s; launches {json.dumps(launches)}")
    return res, launches


# ---------------------------------------------------------------------------
# the mesh phase: mesh=, the sharded pipeline helpers, multi-host, profiling
# ---------------------------------------------------------------------------

MESH_ENTRIES = 4
MESH_TILES_SUBGRID = 8
MESH_TILES_CHUNK = 1024
MESH_REG_N = 8
MESH_REG_ATOL = 1e-6
MESH_MH_N = 4
MESH_MH_TIMEOUT_S = 300
MESH_TRACE_TOP = 5
MESH_STAGES = ("register.adjacency_graph", "register.pairwise_registrations",
               "register.groupwise_resolution", "fuse.plan")
KERNEL_NAMES = ("fuse_translation_3d", "fuse_translation_2d") + EXACT_WRAPPERS


class MeshPhase:
    """The ``mesh:`` lines: each sharded path over ``mesh`` (by default a
    virtual mesh of :data:`MESH_ENTRIES` entries on cuda:0), held to its
    unsharded run on cuda:0; the launches of each kernel inside the sharded
    runs (``mesh_launches``); ``processes`` processes in the multi-host
    part."""

    def __init__(self, np, torch, tf, tea, mesh=None, processes=2):
        from multiview_stitcher_torch.parallel import mesh as tmesh

        self.np, self.torch, self.tf, self.tea = np, torch, tf, tea
        self.card = card_line()
        self.out = {"phase_s": 0.0}
        self.launches = {k: 0 for k in KERNEL_NAMES}
        self.processes = processes
        found = tmesh.get_mesh()
        self.say(f"get_mesh(): size {found.size}, devices {[str(d) for d in found.devices]}")
        self.mesh = mesh or tmesh.Mesh([torch.device("cuda", 0)] * MESH_ENTRIES)
        self.single = tmesh.Mesh([torch.device("cuda", 0)])
        self.say(f"the mesh of this phase: {self.mesh}")

    def say(self, msg):
        log(f"[{self.card}] mesh: {msg}")

    def _counts(self):
        return {k: getattr(self.tf if "translation" in k else self.tea, k).launches
                for k in KERNEL_NAMES}

    def run(self, sharded, fn, *a, **k):
        """``fn(*a, **k)`` to its end on the card: (result, wall s, launches
        by kernel); a ``sharded`` run's launches count in ``mesh_launches``."""
        before = self._counts()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        for d in self.mesh.distinct_devices:
            self.torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        launched = {n: c - before[n] for n, c in self._counts().items()}
        if sharded:
            for n, c in launched.items():
                self.launches[n] += c
        return out, wall, launched

    def part(self, name, fn, *a, **k):
        """Run one part of the phase, keep its result and add its time."""
        t0 = time.perf_counter()
        self.out[name] = fn(*a, **k)
        self.out["phase_s"] += time.perf_counter() - t0

    def translation(self, fuse, sims, mono, ndim):
        """Kernel 1 or 2: fuse(mesh=) of a main path's grid in memory, one
        band a mesh entry, against the unsharded monolithic output."""
        np, torch, tf = self.np, self.torch, self.tf
        name = f"fuse_translation_{ndim}d"
        launch = tf._launch
        bands = []

        def timed_launch(*a, **k):
            # the events on the stream of the band's card, where it launches
            with torch.cuda.device(a[1].device):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = launch(*a, **k)
                e1.record()
            bands.append((a[6].origin, e0, e1))
            return out

        # a one-entry mesh takes the unsharded monolithic tier (no streaming);
        # after a sharded call that puts the tiles on every card, the two run
        # in turns
        walls = {"unsharded": [], "sharded": []}
        band_ms = []
        for which in ("warm", "unsharded", "sharded", "sharded", "unsharded"):
            sharded = which != "unsharded"
            del bands[:]
            tf._launch = timed_launch
            try:
                fused, wall, launched = self.run(
                    sharded, fuse, sims, transform_key=KEY,
                    mesh=self.mesh if sharded else self.single)
            finally:
                tf._launch = launch
            if which != "warm":
                walls[which].append(wall)
            want = {n: (self.mesh.size if sharded else 1) if n == name else 0
                    for n in KERNEL_NAMES}
            if launched != want:
                raise AssertionError(f"{name} mesh ({which}): launches {launched}, want {want}")
            if not np.array_equal(fused.data, mono):
                diff = int(np.abs(fused.data.astype(np.int32) - mono.astype(np.int32)).max())
                raise AssertionError(f"{name} mesh ({which}): output differs from the unsharded "
                                     f"monolithic one by {diff}")
            if sharded:
                band_ms = [(list(o), e0.elapsed_time(e1)) for o, e0, e1 in bands]
            del fused
        res = {"out_shape": list(mono.shape), "bands": band_ms,
               "sharded_warm_s": walls["sharded"], "unsharded_warm_s": walls["unsharded"],
               "bit_equal": True}
        self.say(f"{name}: fuse(mesh=) of the {ndim}D grid, output {tuple(mono.shape)}, "
                 f"{self.mesh.size} bands (origin, kernel ms) {band_ms}; warm wall sharded "
                 f"{walls['sharded']} s, unsharded {walls['unsharded']} s; bit-equal to the "
                 f"unsharded monolithic output")
        return res

    def tiles_tier(self, fuse, tcore, sims, n):
        """The tiles tier (max_fusion) over the mesh: chunk slices a mesh
        entry, against the unsharded call."""
        np = self.np
        sub = [sims[iy * n + ix] for iy in range(MESH_TILES_SUBGRID)
               for ix in range(MESH_TILES_SUBGRID)]
        kw = dict(transform_key=KEY, fusion_func=tcore.max_fusion,
                  output_chunksize=MESH_TILES_CHUNK)
        ref = fuse(sub, **kw).data  # warm: the upload and the first plan
        fuse(sub, mesh=self.mesh, **kw)  # warm: the tiles on every card
        walls = {"unsharded": [], "sharded": []}
        for which in ("unsharded", "sharded", "sharded", "unsharded"):
            sharded = which == "sharded"
            got, wall, launched = self.run(sharded, fuse, sub, mesh=self.mesh if sharded else None,
                                           **kw)
            walls[which].append(wall)
            if any(launched.values()):
                raise AssertionError(f"tiles tier mesh ({which}): launches {launched}, expected "
                                     f"none")
            if not np.array_equal(got.data, ref):
                raise AssertionError(f"tiles tier mesh ({which}): output differs from the "
                                     f"unsharded call")
        res = {"out_shape": list(ref.shape), "sharded_s": walls["sharded"],
               "unsharded_s": walls["unsharded"], "bit_equal": True}
        self.say(f"tiles tier: max_fusion of {MESH_TILES_SUBGRID} x {MESH_TILES_SUBGRID} tiles, "
                 f"output {tuple(ref.shape)}, chunks {MESH_TILES_CHUNK}: warm sharded "
                 f"{walls['sharded']} s, unsharded {walls['unsharded']} s, bit-equal")
        return res

    def exact(self, tcore, batch, kind):
        """Kernels 3, 4 and 5: pipeline.sharded_fuse_chunks_exact of the
        fullest batches of an affine main path (joined until they hold a
        chunk a mesh entry), against the same batch unsharded and the plain
        versions."""
        from multiview_stitcher_torch.parallel import mesh as tmesh
        from multiview_stitcher_torch.parallel import pipeline

        np, torch, tea = self.np, self.torch, self.tea
        name = dict(zip(("2d", "sepy", "general"), EXACT_WRAPPERS))[kind]
        slabs, tables, out_shape = batch["slabs"], batch["tables"], batch["out_shape"]
        ref, unsharded_s, _ = self.run(
            False, tcore._fuse_chunk_batch_kernel_exact, slabs, *tables, out_shape,
            "weighted_average", True, kind)
        for _ in range(2):  # the first call loads the kernels on every card
            got, sharded_s, launched = self.run(
                True, pipeline.sharded_fuse_chunks_exact, slabs, *tables, out_shape, self.mesh)
        parts = sum(1 for lo, hi in tmesh.shard_bounds(len(slabs), self.mesh) if hi > lo)
        want = {n: 2 * parts if n == name else 0 for n in KERNEL_NAMES}
        if launched != want:
            raise AssertionError(f"{name} mesh: launches {launched}, want {want}")
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} mesh: sharded batch differs from the unsharded one by "
                                 f"{float((got - ref).abs().max())}")
        saved = {n: getattr(tea, n) for n in EXACT_WRAPPERS}
        try:
            for n in EXACT_WRAPPERS:
                setattr(tea, n, getattr(tea, n + "_plain"))
            plain = pipeline.sharded_fuse_chunks_exact(slabs, *tables, out_shape, self.mesh)
        finally:
            for n, fn in saved.items():
                setattr(tea, n, fn)
        top = float(slabs.max())
        tol = max(float(UINT_COUNTS), EXACT_ATOL * max(top, 100.0) / 100.0)
        err = float((got - plain).abs().max())
        if err > tol:
            raise AssertionError(f"{name} mesh: sharded batch differs from its plain version by "
                                 f"{err} (tolerance {tol})")
        res = {"batch": list(slabs.shape), "parts": parts, "launches": launched[name],
               "sharded_s": sharded_s, "unsharded_s": unsharded_s, "plain_max_abs_err": err,
               "bit_equal": True}
        self.say(f"{name}: sharded_fuse_chunks_exact of the {batch['batches']} fullest batches "
                 f"{tuple(slabs.shape)} "
                 f"-> {tuple(got.shape)} in {parts} parts, {launched[name]} launches a call, "
                 f"sharded {sharded_s * 1e3:.2f} ms (its second call), unsharded "
                 f"{unsharded_s * 1e3:.2f} ms (host clock, to the end on every card), "
                 f"bit-equal to the unsharded batch, {err:.3g} from the plain versions "
                 f"(tolerance {tol:.3g})")
        return res

    def register(self, tsi, tstitch, treg, tmsi, tprof):
        """register(mesh=) of an 8 x 8 grid of 64^3 tiles from host crops and
        from the resident stack, against the unsharded call; stitch()'s
        stage times."""
        np, torch = self.np, self.torch
        from multiview_stitcher_torch.fusion import _core as tcore

        sims, _, _ = stitch_grid_sims(np, tsi, MESH_REG_N, 64, 12, seed=17)
        res = {}

        def register(device_tiles, mesh):
            tcore.clear_device_tile_cache()
            msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in sims]
            t0 = time.perf_counter()
            params = np.stack([np.asarray(p.data) for p in treg.register(
                msims, transform_key=KEY, overlap_tolerance=STITCH_TOLERANCE,
                device_tiles=device_tiles, mesh=mesh)])
            torch.cuda.synchronize()
            return params, time.perf_counter() - t0

        register(False, None)  # warm: cuFFT plans, the crop shapes' first batches
        for device_tiles in (False, True):
            params, walls = {}, {}
            for which in ("unsharded", "sharded"):
                params[which], walls[which] = register(
                    device_tiles, self.mesh if which == "sharded" else None)
                if treg.last_telemetry["device_tiles"] != device_tiles:
                    raise AssertionError(f"register mesh: device_tiles {device_tiles}, telemetry "
                                         f"{treg.last_telemetry}")
            err = float(np.abs(params["sharded"] - params["unsharded"]).max())
            if err > MESH_REG_ATOL:
                raise AssertionError(f"register mesh (device_tiles={device_tiles}): parameters "
                                     f"{err} px from the unsharded call")
            key = "device_tiles" if device_tiles else "host_crops"
            res[key] = {"max_abs_err_px": err, "sharded_s": walls["sharded"],
                        "unsharded_s": walls["unsharded"],
                        "pairs": int(treg.last_telemetry["pairs"])}
            self.say(f"register(mesh=), {MESH_REG_N} x {MESH_REG_N} tiles of 64^3, {key}: "
                     f"{res[key]['pairs']} pairs, parameters {err:.3g} px from unsharded "
                     f"(bound {MESH_REG_ATOL}), sharded {walls['sharded']:.3f} s, unsharded "
                     f"{walls['unsharded']:.3f} s")
        tcore.clear_device_tile_cache()
        tprof.reset_stage_times()
        tstitch.stitch(sims, register_kwargs={"overlap_tolerance": STITCH_TOLERANCE})
        torch.cuda.synchronize()
        stages = tprof.get_stage_times()
        missing = [s for s in MESH_STAGES if s not in stages]
        if missing:
            raise AssertionError(f"stitch() recorded {sorted(stages)}, missing {missing}")
        res["stitch_stage_times"] = stages
        self.say("stitch() stage times " + json.dumps(stages))
        tcore.clear_device_tile_cache()
        return res

    def multihost(self, tsi, tngff, texec, tmh, work):
        """``processes`` processes (gloo on localhost, torchrun's variables
        set here; process k on card k modulo the cards) run multihost_fuse
        of a 4 x 4 zarr grid into one store, byte-equal to one process's."""
        np = self.np
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            sims, truth, _ = stitch_grid_sims(np, tsi, MESH_MH_N, 64, 12, seed=19)
            specs = []
            for i, (s, t) in enumerate(zip(sims, truth)):
                url = str(work / f"tile{i}.ome.zarr")
                tngff.write_sim_to_ome_zarr(s, url, overwrite=True)
                specs.append({"url": url, "origin": dict(zip("zyx", map(float, t)))})
            t0 = time.perf_counter()
            tmh.multihost_fuse([texec.SourceSpec(**s) for s in specs], str(work / "single.zarr"),
                               KEY, output_chunksize=64)
            single_s = time.perf_counter() - t0
            cfg = work / "cfg.json"
            cfg.write_text(json.dumps({"specs": specs, "out": str(work / "multi.zarr")}))
            driver = (
                "import json, sys\n"
                f"sys.path.insert(0, {str(REPO)!r})\n"
                "from multiview_stitcher_torch.parallel import executors, multihost\n"
                "cfg = json.load(open(sys.argv[1]))\n"
                "multihost.initialize()\n"
                "pid, n = multihost.process_info()\n"
                f"assert n == {self.processes}, n\n"
                "specs = [executors.SourceSpec(**s) for s in cfg['specs']]\n"
                f"multihost.multihost_fuse(specs, cfg['out'], {KEY!r}, output_chunksize=64)\n"
                "print('process', pid, 'of', n, 'done', flush=True)\n"
            )
            port = free_port()
            procs = []
            t0 = time.perf_counter()
            try:
                for rank in range(self.processes):
                    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                               WORLD_SIZE=str(self.processes), RANK=str(rank),
                               LOCAL_RANK=str(rank))
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", driver, str(cfg)], env=env,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                deadline = time.monotonic() + MESH_MH_TIMEOUT_S
                outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                        for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            multi_s = time.perf_counter() - t0
            if any(p.returncode for p in procs):
                raise AssertionError("multihost: a process failed:\n" + "\n".join(outs))
            a, b = work / "single.zarr", work / "multi.zarr"
            files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
            if files != sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file()):
                raise AssertionError("multihost: the two stores hold different files")
            for f in files:
                if (a / f).read_bytes() != (b / f).read_bytes():
                    raise AssertionError(f"multihost: {f} differs between the stores")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        res = {"files": len(files), "single_process_s": single_s, "processes": self.processes,
               "multi_process_s": multi_s}
        self.say(f"multihost_fuse of {MESH_MH_N} x {MESH_MH_N} zarr tiles of 64^3: one process "
                 f"{single_s:.2f} s, {self.processes} processes (gloo on localhost) "
                 f"{multi_s:.2f} s from their start, {len(files)} files byte-equal")
        return res

    def trace(self, fuse, sims, tprof, work):
        """device_trace around one warm fuse() of the 3D grid: the CUDA ops
        with the most device time; kernel 1 must be among them."""
        torch = self.torch
        fuse(sims, transform_key=KEY)  # warm
        torch.cuda.synchronize()
        with tprof.device_trace(str(work)) as prof:
            fuse(sims, transform_key=KEY)
            torch.cuda.synchronize()
        size = (work / "trace.json").stat().st_size
        shutil.rmtree(work, ignore_errors=True)

        def device_us(e):
            for attr in ("self_device_time_total", "self_cuda_time_total"):
                v = getattr(e, attr, None)
                if v is not None:
                    return float(v)
            return 0.0

        events = sorted(prof.key_averages(), key=device_us, reverse=True)
        top = [(e.key, device_us(e) / 1e3) for e in events[:MESH_TRACE_TOP] if device_us(e) > 0]
        if not any("fuse_translation_3d" in k for k, _ in top):
            raise AssertionError(f"trace: kernel 1 is not among the top CUDA ops {top}")
        res = {"top": top, "trace_bytes": size}
        self.say(f"device_trace of one warm fuse() of the 3D grid ({size} bytes of Chrome "
                 f"trace): top CUDA ops by device ms " + json.dumps(top))
        return res


def free_port() -> int:
    """A TCP port on localhost that no process holds now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def capture_fullest_batches(np, torch, tcore, run, min_chunks):
    """Run ``run()`` with ``_fuse_chunk_batch_kernel_exact`` watched; return
    the batches with the most valid view slots, fullest first, until they
    hold ``min_chunks`` chunks, joined into one batch (the batches of a plan
    share their slot count and window): its slabs (cut from the device
    stack, float32), host tables and output shape."""
    orig = tcore._fuse_chunk_batch_kernel_exact
    calls = []

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.array(x)

    def watch(data, mats, offs, extents, wgrids, wmats, woffs, view_valid, out_shape,
              mode="weighted_average", use_bw=True, kind="sepy", out_dtype=torch.float32,
              tile_idx=None, starts=None):
        if mode == "weighted_average" and use_bw:
            calls.append({
                "n": int(np.sum(view_valid)), "data": data, "out_shape": tuple(out_shape),
                "kind": kind, "tile_idx": None if tile_idx is None else host(tile_idx),
                "starts": None if starts is None else host(starts),
                "tables": tuple(host(x) for x in (mats, offs, extents, wgrids, wmats, woffs,
                                                  view_valid)),
            })
        return orig(data, mats, offs, extents, wgrids, wmats, woffs, view_valid, out_shape, mode,
                    use_bw, kind, out_dtype, tile_idx=tile_idx, starts=starts)

    tcore._fuse_chunk_batch_kernel_exact = watch
    try:
        out = run()
    finally:
        tcore._fuse_chunk_batch_kernel_exact = orig
    chosen, chunks = [], 0
    for c in sorted(calls, key=lambda c: -c["n"]):
        if chunks >= min_chunks:
            break
        chosen.append(c)
        chunks += len(c["tables"][-1])
    nd = len(chosen[0]["out_shape"])
    S = tuple(int(x) for x in np.concatenate(
        [c["tables"][2].reshape(-1, nd) for c in chosen]).max(0))
    slabs = []
    for c in chosen:
        B, K = np.shape(c["tables"][-1])
        ext = c["tables"][2].reshape(-1, nd)
        if c["tile_idx"] is None:
            slabs.append(c["data"].to(torch.float32))
        else:
            slabs.append(tcore._slabs_from_stack(
                c["data"], c["tile_idx"].reshape(-1), c["starts"].reshape(-1, nd), ext, S,
            ).reshape((B, K) + S))
    return out, {
        "slabs": torch.cat(slabs),
        "tables": tuple(np.concatenate(t) for t in zip(*(c["tables"] for c in chosen))),
        "out_shape": chosen[0]["out_shape"], "kind": chosen[0]["kind"],
        "batches": len(chosen),
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    if not (REPO / "multiview_stitcher_torch").is_dir():
        print(f"chip_smoke: no multiview_stitcher_torch package beside {__file__}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from multiview_stitcher_torch import si_utils as tsi
    from multiview_stitcher_torch import weights as tweights
    from multiview_stitcher_torch.fusion import _core as tcore
    from multiview_stitcher_torch.fusion import _streaming as tstream
    from multiview_stitcher_torch.fusion import fuse
    from multiview_stitcher_torch.ops import _build
    from multiview_stitcher_torch.ops import exact_affine as tea
    from multiview_stitcher_torch.ops import translation_fusion as tf

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # probed in a child process, so that this one imports none of them
    found = {m: subprocess.run([sys.executable, "-c", f"import {m}"], capture_output=True,
                               timeout=120).returncode == 0
             for m in ("zarr", "numcodecs", "blosc")}
    log("modules that import here (the port's zarr IO needs none; blosc chunks need "
        "numcodecs or blosc): " + json.dumps(found))
    from multiview_stitcher_torch.io import codecs as tcodecs

    reader_found = probe_modules(READERS_OPTIONAL)
    log("optional packages of the readers that import here: " + json.dumps(reader_found)
        + f"; the C compiler of the TIFF codecs: {tcodecs.compiler()}")

    names, paths, build_s = build_all(_build)
    log(f"build: {names} in {build_s:.1f} s")
    for p in paths:
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    log("kernels against their plain versions on small cases:")
    t_small = time.perf_counter()
    small_err = check_small_cases(np, torch, tsi, tcore, tf)
    exact_err = check_exact_small_cases(np, torch, tea)
    f1_err = check_f1_fuse(np, torch, tsi, tf, tea, fuse)
    pyramid = pyramid_phase(np, torch)
    scoring = scoring_phase(np, torch)
    small_s = time.perf_counter() - t_small
    log(f"small cases: {small_s:.1f} s")
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch import stitch as tstitch
    from multiview_stitcher_torch.io import ngff_utils as tngff
    from multiview_stitcher_torch.parallel import executors as texec
    from multiview_stitcher_torch.parallel import multihost as tmh
    from multiview_stitcher_torch.utils import profiling as tprof

    # the mesh phase runs in parts beside the main paths whose data it reuses
    mesh = MeshPhase(np, torch, tf, tea)

    r3, sims3, mono3, streamed3 = main_path(np, torch, tsi, tcore, tf, tea, tstream, fuse, 3,
                                            n=32, tile=64, overlap=12, band_tiles=2)
    work = REPO / ".bench_large" / "chip_smoke_zarr"
    zarr, lazy3 = zarr_north_star(np, torch, tsi, tf, tstream, fuse, sims3, mono3, work)
    try:
        # the link codec's round trips on the same tiles
        link = link_phase(np, torch, sims3)
        # reuse across calls: the resident stack, seeding, the resume stash, plans
        cache = cache_phase(np, torch, tcore, tf, tea, tstream, fuse, sims3, mono3, streamed3,
                            lazy3, work)
        del streamed3
        # the same tiles into NGFF 0.5, sharded, against phase 5's store
        t_phase = time.perf_counter()
        zarr3 = zarr3_phase(np, torch, tf, tstream, fuse, lazy3, work,
                            str(work / "fused.ome.zarr"), zarr["warm"]["wall_s"])
        zarr3["phase_s"] = time.perf_counter() - t_phase
        log(f"zarr3: phase {zarr3['phase_s']:.1f} s")
        # the public API slice on the same tiles: block-wise fusion, the
        # output kept on the card, the host names at this size
        api = api_phase(np, torch, tsi, tcore, tf, tea, fuse, sims3, mono3, lazy3,
                        r3["download_ms"], work)
        # kernel 1 over the virtual mesh, and a trace of the streamed path
        mesh.part("kernel_1", mesh.translation, fuse, sims3, mono3, 3)
        mesh.part("trace", mesh.trace, fuse, sims3, tprof,
                  REPO / ".bench_large" / "chip_smoke_trace")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del sims3, mono3, lazy3
    torch.cuda.empty_cache()

    # lazy views larger than TILES_MAX_BYTES: the host-slab route
    t_phase = time.perf_counter()
    slabs, slab_launches = slabs_phase(np, torch, tsi, tcore, tea, tf, fuse,
                                       REPO / ".bench_large" / "chip_smoke_slabs")
    slabs["phase_s"] = time.perf_counter() - t_phase
    log(f"slabs: phase {slabs['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the shear tier, MVS_TPU_SHEAR=1 inside the phase only
    t_phase = time.perf_counter()
    shear = shear_phase(np, torch, tsi, tcore, tea, tf, fuse)
    shear["phase_s"] = time.perf_counter() - t_phase
    log(f"shear: phase {shear['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    # 2D bands of 16 view-list tiles of 64 rows: about 1024 output rows each
    r2, sims2, mono2, _ = main_path(np, torch, tsi, tcore, tf, tea, tstream, fuse, 2, n=32,
                                    tile=512, overlap=64, band_tiles=16)
    # kernel 2 over the virtual mesh, and the tiles tier on a corner of the scan
    mesh.part("kernel_2", mesh.translation, fuse, sims2, mono2, 2)
    mesh.part("tiles_tier", mesh.tiles_tier, fuse, tcore, sims2, 32)
    del sims2, mono2
    torch.cuda.empty_cache()

    def coupling(rng):
        return np.eye(3) + rng.uniform(0.005, 0.02, (3, 3)) * rng.choice([-1, 1], (3, 3))

    def rotate_and_scale(rng):
        return rot2(np, np.deg2rad(rng.uniform(-0.5, 0.5)), 1 + rng.uniform(-0.005, 0.005))

    affine = {}
    for kind, label, chunksize, make in (
        ("sepy", "3d multi-view, rotated about y", 128,
         lambda: multiview_sims(np, tsi, (256, 512, 512), (0, 47, 92, 137), seed=4)),
        ("general", "3d grid, affine-resolved", 128,
         lambda: affine_grid_sims(np, tsi, 3, 4, 256, 32, 5, coupling)),
        ("2d", "2d slide scan, per-tile affines", 1024,
         lambda: affine_grid_sims(np, tsi, 2, 16, 1024, 64, 6, rotate_and_scale)),
    ):
        sims = make()
        affine[kind] = affine_main_path(
            np, torch, tcore, tf, tea, fuse, label, sims, chunksize, kind
        )
        if kind == "2d":
            cache["affine_2d"] = affine_plan_repeat(np, torch, tcore, tf, tea, fuse, sims,
                                                    chunksize)

        def exact_part():
            # the fullest batch of one more warm call, through the sharded helper
            _, batch = capture_fullest_batches(
                np, torch, tcore,
                lambda: fuse(sims, transform_key=KEY, output_chunksize=chunksize), MESH_ENTRIES)
            return mesh.exact(tcore, batch, kind)

        mesh.part(f"exact_{kind}", exact_part)
        del sims
        torch.cuda.empty_cache()

    # the general fusion path: the host tier, the tiles tier, the gather route
    t_general = time.perf_counter()
    general = general_phase(np, torch, tsi, tcore, tweights, tea, tf, fuse)
    general["phase_s"] = time.perf_counter() - t_general
    log(f"general: phase {general['phase_s']:.1f} s")

    # msims and time: pyramids, register over levels and t, fuse to a pyramid
    multiscale = multiscale_phase(np, torch, tsi, tcore, tf, fuse,
                                  REPO / ".bench_large" / "chip_smoke_multiscale")
    torch.cuda.empty_cache()

    # bead-based multi-view registration: detect -> markers -> resolve -> fuse
    beads, bead_sims = beads_phase(np, torch, tsi, tcore, tea, tf, fuse)
    torch.cuda.empty_cache()

    # multi-view deconvolution of the registered bead views
    deconv = deconv_phase(np, torch, tcore, tea, tf, fuse, bead_sims,
                          "beads_global_optimization")
    del bead_sims
    torch.cuda.empty_cache()

    # the north star's second half: register -> resolve -> fuse on the card
    stitched, grid = stitch_phase(np, torch, tsi, tcore, tf, tstream, fuse, n=32, tile=64,
                                  overlap=12)

    # the registration's quality over the whole mosaic
    quality = metrics_phase(np, torch, tea, tf, n=32, **grid)
    del grid
    torch.cuda.empty_cache()

    # the user's files: the readers to stitch() and fuse() on the card
    readers, readers_launches = readers_phase(np, torch, tsi, tcore, tf, tea, tstream, fuse,
                                              REPO / ".bench_large" / "chip_smoke_readers",
                                              reader_found)
    torch.cuda.empty_cache()

    # the mesh phase's last parts: register(mesh=), stitch()'s stages, two processes
    mesh.part("register", mesh.register, tsi, tstitch, treg, tmsi, tprof)
    mesh.part("multihost", mesh.multihost, tsi, tngff, texec, tmh,
              REPO / ".bench_large" / "chip_smoke_multihost")
    mesh.say(f"phase {mesh.out['phase_s']:.1f} s in all")
    torch.cuda.empty_cache()

    # the serving path: a session over the slide scan, workers over bridges
    service, service_launches = service_phase(np, torch, tsi, tcore, tf, tea, fuse,
                                              REPO / ".bench_large" / "chip_smoke_service")
    torch.cuda.empty_cache()

    source = "multiview_stitcher_torch/csrc/translation_fusion.cu"
    exact_source = "multiview_stitcher_torch/csrc/exact_affine.cu"
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "fuse_translation_3d", "route": "cuda", "source": source,
         "replaces": "multiview_stitcher_tpu/ops/pallas_fusion.py:399",
         **{k: r3[k] for k in keys}},
        {"name": "fuse_translation_2d", "route": "cuda", "source": source,
         "replaces": "multiview_stitcher_tpu/ops/pallas_fusion.py:100",
         **{k: r2[k] for k in keys}},
        {"name": "exact_affine_batch_2d", "route": "cuda", "source": exact_source,
         "replaces": "multiview_stitcher_tpu/ops/exact_affine.py:101",
         **{k: affine["2d"][k] for k in keys}},
        {"name": "exact_affine_batch_3d_sepy", "route": "cuda", "source": exact_source,
         "replaces": "multiview_stitcher_tpu/ops/exact_affine.py:349",
         **{k: affine["sepy"][k] for k in keys}},
        {"name": "exact_affine_batch_3d_general", "route": "cuda", "source": exact_source,
         "replaces": "multiview_stitcher_tpu/ops/exact_affine.py:643",
         **{k: affine["general"][k] for k in keys}},
    ]
    for k, worst in zip(kernels, (small_err[3], small_err[2], exact_err["2d"],
                                  exact_err["sepy"], exact_err["general"])):
        k["max_abs_err"] = max(k["max_abs_err"], worst)
        k["beads_launches"] = beads["fuse"]["launches"][k["name"]]
        k["deconv_launches"] = deconv["fuse"]["launches"][k["name"]]
        k["metrics_launches"] = quality["launches"][k["name"]]
        k["api_launches"] = api["blocks"]["launch_counts"][k["name"]]
        k["slab_launches"] = slab_launches[k["name"]]
        k["readers_launches"] = readers_launches[k["name"]]
        k["mesh_launches"] = mesh.launches[k["name"]]
        k["service_launches"] = service_launches[k["name"]]
        k["cache_launches"] = {
            "fuse_translation_3d": cache["launches"] + r3["resident_launches"],
            "fuse_translation_2d": r2["resident_launches"],
            "exact_affine_batch_2d": cache["affine_2d"]["launches"],
        }.get(k["name"], 0)
    # its main-path run is the zarr north star's warm run (counter set to 0
    # just before it); the timed repetitions' count stays in the detail
    kernels.append({"name": "coarsen_mean", "route": "cuda",
                    "source": "multiview_stitcher_torch/csrc/pyramid.cu", "replaces": None,
                    **{k: pyramid[k] for k in keys if k != "launches"},
                    "launches": zarr["pyramid_launches"]})
    # its main-path launches: the stitch phase's warm stitch(), two a batch
    kernels.append({"name": "score_candidates", "route": "cuda",
                    "source": "multiview_stitcher_torch/csrc/candidate_scoring.cu",
                    "replaces": None, **{k: scoring[k] for k in keys if k != "launches"},
                    "launches": stitched["score_launches"]})
    detail = {"3d": r3, "2d": r2, "pyramid": pyramid, "scoring": scoring, "zarr": zarr,
              "link": link, "cache": cache, "zarr3": zarr3,
              "api": api, "slabs": slabs,
              "shear": shear, **{f"affine_{k}": v for k, v in affine.items()},
              "general": general, "multiscale": multiscale, "beads": beads, "deconv": deconv,
              "stitch": stitched, "metrics": quality, "readers": readers, "mesh": mesh.out,
              "service": service,
              "f1_fuse_max_abs_err": f1_err, "build_s": build_s, "small_cases_s": small_s,
              "total_s": time.perf_counter() - t_start}
    log("detail: " + json.dumps(detail))
    log(f"chip_smoke: every phase ran and held, {detail['total_s']:.1f} s in all")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
