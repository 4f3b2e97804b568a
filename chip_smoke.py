#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (tungsten_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero without
printing a result):
  1. device   - the card's name and power limit;
  2. build    - the host's BVH builder (native/, portable flags) is built
                beside the kernels where it is absent; nvcc builds the
                thirteen kernel sources (csrc/bvh8_walk.cu,
                bvh8_walk_fast.cu, bvh8_walk_v1.cu, bvh8_walk_fast_v1.cu,
                bvh2_walk.cu, bvh2_walk_v1.cu, bvh_walk.cu, bvh_walk_v1.cu,
                intersect_stream.cu, intersect_stream_v1.cu, gather_walk.cu,
                grid_walk.cu, photon_walk.cu)
                into build/, one nvcc per source, all at once, and prints
                what ptxas said of the two BVH8 kernels, K4, K5, K2, K1, K6
                and K7
                (registers, shared memory, stack, spills) and their resident
                blocks a multiprocessor (K4's kernel in each of its three
                modes);
  3. kernel   - materialtest-synth flattened, with what its gather pack
                (gbvh) costs the flatten: build_gather_pack timed on the
                flatten's BVH build (so also on interior-synth in phase 8);
                the BVH8 walk (K3) against its plain PyTorch twin at the
                slice's shapes on the materialtest-synth pack (65,536 random
                rays and the 2N = 1,126,000-lane mixed shadow + camera batch:
                the camera rays, closest hit, plus latched shadow lanes from
                their hit points, half with a finite tfar, half with INF, and
                tfar = 0 (dead) where the camera ray missed) and against
                brute force on 8,192 rays; against its one-thread-per-ray
                form (bvh8_walk_v1.cu) bit for bit in closest, latched and
                mixed mode on the random rays, the 563,000 camera rays and the
                2N batch; times v1 and K3 at 2N in turns (v1, new, new, v1,
                each the median of 5 launches);
  3b. kernels - K4 (bvh2_walk) on the same scene's packs, in its three
                modes on the 65,536 random rays, the 563,000 camera rays and
                the 2N batch (phase 3's rays and tfar, every lane closest hit
                in "ordered" and "skip", every lane any-hit in "any"): against
                its twin and its first form (bvh2_walk_v1.cu) by the bars (the
                new kernel's leaf rounds as K3's does, the first form's as
                the compiler contracted it; on the 2N set the all-lanes t bar
                has phase 3d's grazing floor; the lanes that differ counted
                and printed), and against exact K3 on the same rays (the
                packs share their plane leaves): "ordered" and "skip" by slot
                on >= 99.99% of the lanes, t bit for bit where it agrees;
                "any" against K3's latch by occlusion on >= 99.99% of the
                lanes (the two walks reach different first leaves, so their
                slots differ), the lanes that differ printed; each K4 walk
                against its first form at 2N in turns; K5 (bvh_walk) in both
                modes (prune=1:
                K5-v2, prune=0: K5-v1) against its twin and its first CUDA
                form (bvh_walk_v1.cu) bit for bit in t, slot, u and v on those
                two sets and on the 2N closest-hit batch that the render's K5
                and K2 routes give the walk (phase 3's rays and tfar with no
                lane latched); each through its public query against brute
                force on the 8,192 rays; each kernel's launch count must move
                there and its twin's and first form's not;
  3c. kernels - K2 (intersect_stream) on the three sets: its prim against its
                twin's on >= 99.99% of the lanes (the kernel culls per ray and
                per sub-box, the twin per 256-ray tile), t, u and v bit for
                bit where the prims agree, the lanes that differ counted and
                printed; its first CUDA form (intersect_stream_v1.cu) against
                the twin bit for bit; the tests its sub-box cull leaves on the
                2N batch counted (sub_box_work), for its bound; through its
                query against brute force on the 8,192 rays, with the launch
                counts checked; then K5-v2, K5-v1 and K2 against their first
                forms on the 2N batch, in turns (first form, new, new, first
                form);
  3d. K3-fast - the fast BVH8 walk (bvh8_walk_fast.cu) on the same pack: the
                raw kernel against its twin (walk_fast_twin), bit for bit, on
                the 65,536 random rays, the 563,000 camera rays and the 2N
                closest-hit batch of phase 3b; the whole query (fast walk,
                exact validation, exact repair launch) against brute force
                on the 8,192 rays and against the exact K3 query on all three
                sets (>= 99.99% the same prim, or a tie of two coincident
                triangles at one t: the cube stands on the floor quad); the
                phantoms (= repair lanes) of each set counted, and what the
                repair found for them; the 2N set's repair launch (closest
                hit, tfar = 0 on every lane but the phantoms) through the
                exact K3 kernel against its twin and against v1 (bit for bit);
                launch counts; the kernel, its twin, the exact K3 kernel, the
                repair launch and both whole queries timed on the 2N rays. The
                tensor core sums in its own order, so the raw kernel is held
                to its twin and to its one-thread-per-ray form
                (bvh8_walk_fast_v1.cu, itself bit-equal to the twin) by bars:
                the slot equal on >= 99.9% of lanes, t where the slots agree
                by the t bar below (with the grazing floor on all lanes). The
                fast kernel and the repair launch against v1 are timed in
                turns;
  3e. K1     - the gather walk (gather_walk.cu) on the materialtest-synth
                gbvh pack: against its twin bit for bit in t, prim, u and v
                in closest, latched and mixed mode on the 65,536 random rays,
                the 563,000 camera rays and the 2N batch; its query against
                brute force on the 8,192 rays (prim); against exact K3 on the
                2N batch (prim on the closest-hit lanes, occlusion on the
                latched ones, the lanes that differ printed); K3 and K1 at
                2N in turns (K3, K1, K1, K3); the twin's node and leaf
                rounds, for the bound;
  4. small    - the `small` scene through render_scene, its per-channel
                means against the JAX package's (tests/data/...json);
  4b. analytic - `small-analytic` (three analytic prims) the same way,
                against tests/data/torch_port_analytic_ref.json;
  4c. lights  - `small-area` (area lights beside the sky) and `small-box` (a
                closed box, one emissive quad, no env) through render_scene
                in both wavefronts (regen, lockstep) against
                tests/data/torch_port_{area,box}_ref.json. The small scenes
                are flattened on the numpy BVH build, as the references
                were: the tree fixes the triangle order and with it which
                light point a random number picks;
  5. slice    - materialtest-synth at 1000x563 and 32 spp through
                load_scene / flatten_scene / render_flat, with the walk's
                launch counts reset just before and read just after;
  5b. lockstep - the slice of the lockstep path tracer at full width:
                materialtest-area (materialtest-synth plus an emissive quad
                and an emissive mesh) at 1000x563, 4 spp (cut from the
                scene's 32 to make room for phase 8), 64 bounces through
                render_flat(wavefront="lockstep"), the launch counts reset
                just before and read just after: the fast kernel launches
                once per camera walk and once per bounce run, the exact K3
                kernel once per shadow walk and once per repair, no twin
                launches; then the same scene through wavefront="regen" at
                32 spp, the two images' channel means within 5e-3. Wall time
                and Mpaths/s of both;
  6. isect    - the intersector benchmark (tungsten_tpu_torch.tools.bench_isect)
                at n = 131,072 on both ray kinds and the all-dead case, all
                ten walks and the nine first forms (v1 walks; 57 timed rows;
                bvh8fast is the raw fast kernel, bvh8fastq the whole fast
                query), with
                every agreement >= 99.9% (K2 the brute-force reference of
                every walk on the coherent rays) and the launch counts reset
                just before and read just after; then K3 closest, K3 latched
                and K3-fast against their v1 forms on the benchmark's coherent
                and incoherent rays, in turns, and so K4 (ordered, skip,
                any), K5 (both modes) and K2 against their first forms;
  7. routes   - materialtest-analytic at 1000x563 and 32 spp through
                render_flat on four FlatScenes of one flatten: all packs
                (the render walks K3), pbvh8 = None (K1), pbvh8 = gbvh =
                pbvh3 = None (K5-v2) and pbvh8 = gbvh = pbvh3 = pbvh = None
                (K2). Each route launches its kernel and nothing else; each
                image is finite and non-negative; the K1, K5 and K2 images'
                channel means lie within 5e-3 of the K3 image's, >= 90% of
                their pixels within 1e-3 + 1e-3 |K3|. Wall time and Mpaths/s
                per route.
  8. interior - the interior cell's surfaces (dielectric, rough_dielectric,
                plastic, rough_plastic with a checker roughness, conductor,
                mirror, a null-BSDF light fixture, an .hdr sky):
                synth.write_scene writes small-interior and interior-synth,
                their skies through the port's RGBE writer, and the reader
                must give the sky back within RGBE's 8-bit mantissa;
                small-interior through render_scene in both wavefronts
                against tests/data/torch_port_interior_ref.json (numpy BVH
                build); interior-synth flattened, one regen pass (1 spp)
                counting each BSDF type's hits (all seven new types hit),
                then at 1000x563, 64 bounces through regen (32 spp) and
                lockstep (10 spp) with the launch counts reset just before
                and read just after each: K3 and K3-fast launch in both (regen's
                closest-hit walks also go through K3-fast), lockstep's
                counts add up as in phase 5b, no other walk, twin or v1
                kernel; each image finite and non-negative, the two
                wavefronts' channel means within 5e-3. Wall time and
                Mpaths/s of both.
  9. surfaces - the remaining surfaces (smooth_coat, rough_coat, mixed,
                transparency, oren_nayar, phong, diffuse_transmission,
                thinsheet, forward) and the lockstep tracer's forward-lobe
                branch: small-coat through render_scene in both wavefronts
                and small-cutout through lockstep against
                tests/data/torch_port_{coat,cutout}_ref.json (numpy BVH
                build); coat-synth and cutout-synth flattened; one profile
                window each (torch.profiler, CUDA activity): one regen batch
                of 1 pass of coat-synth and one lockstep pass of cutout-synth,
                both of PROFILE_BOUNCES = 8 bounces, each run once bare
                (coat's counting each BSDF type's hits: every new type must
                be hit) and once profiled,
                printing the CUDA kernels per iteration, the device-busy share
                and the five kernels of most device time; then coat-synth at
                1000x563 through regen (32 spp) and lockstep (4 spp) and
                cutout-synth through lockstep (3 spp; forward lobes: the
                crossing-walk branch), each counting the BSDF types' hits
                (every new type of the scene must be hit), the launch counts
                reset just before and read just after each: K3 and K3-fast
                launch, no other walk, twin or v1
                kernel; coat's lockstep counts add up as in phase 5b,
                cutout's as the forward branch walks (per bounce one path
                walk, and one 2N crossing walk of 1-8 steps; each a fast
                launch with its repair, no shadow walk); each image finite
                and non-negative; coat-synth's two wavefronts' channel means
                within 5e-3. Wall time, iterations and Mpaths/s of each.
  10. lights  - every light kind but the skydome: small-lights (an emissive
                sphere, a disk with a 30-degree cone and a cylinder, two
                envs, two caps, a point light) through render_scene in both
                wavefronts against tests/data/torch_port_lights_ref.json
                (numpy BVH build); lights-synth at 1000x563 through regen
                (32 spp) and lockstep (LIGHTS_LOCKSTEP_SPP = 2), each
                counting the light rows NEE chose (count_light_choices:
                every row, so every kind, chosen), the launch counts reset
                just before and read just after (K3 and K3-fast only;
                lockstep's counts add up as in phase 5b), each image finite
                and non-negative; the two wavefronts' channel means printed.
                Wall time and Mpaths/s of each.
  11. camera  - the cameras, the tabulated filters, the AOVs, the render
                driver and the CLI: small-camera (thinlens with a 6-blade
                aperture, cat-eye and focus pivot under mitchell_netravali;
                the same with a bitmap aperture; equirectangular under
                lanczos; a 96x16 cubemap under catmull_rom) through
                render_buffers in both wavefronts against
                tests/data/torch_port_camera_ref.json (numpy BVH build): the
                channel means and the depth / normal / albedo means (each
                AOV's within 5e-3 of its largest channel mean); then
                camera-synth at full width: the port's CLI
                (tungsten_tpu_torch.tools.tungsten.main, in process, one
                scene) on the thinlens variant at 1000x563, 32 spp (regen, two
                batches of 16, adaptive sampling off), its resume file on:
                the LDR, HDR and three AOV files written, the image finite
                and non-negative, the AOVs plausible (at the ball's centre,
                whose albedo is 1, each pixel's normal is its albedo's share
                of a unit vector, depth > 0 there); resume: 16 spp saved, then
                resumed to 32, equals the CLI's straight 32-spp state bit for
                bit (sums, counts, halves, Welford state, AOV sums and
                counts); an adaptive render (16 warm-up passes, then 4
                adaptive lockstep passes): every count >= 16, the counts not
                uniform, the whole budget spent, the image finite, K3-fast
                launched; the equirectangular (1000x500) and cubemap
                (1536x256) variants at 16 spp through regen, each image
                finite. Each render's launch counts reset just before and
                read just after (K3 and K3-fast only); wall time and
                Mpaths/s of each.
  12. media   - participating media: small-media's four variants (fog:
                a homogeneous camera medium with the davis transmittance and
                a Henyey-Greenstein phase; cloud: a 16^3 voxel medium with an
                emission grid in an index-matched box; haze: an exponential
                camera medium and an absorption-only atmosphere in an
                analytic sphere; forward: fog with forward lobes) in every
                wavefront the JAX package runs them in, against
                tests/data/torch_port_media_ref.json (numpy BVH build): K3
                and K3-fast launched, K6 in the cloud's renders only, no
                twin; media-synth written (the cloud a 192^3 blob as a zip
                5-4-3 .vdb by synth's writer) and flattened, the grid read
                back bit for bit; K6 (grid_walk.cu) against its twin in both
                modes, bit for bit (or within rtol 1e-6 on >= 99.9% of the
                finite lanes, INF lanes equal), on 65,536 random rays
                through the cloud and on the largest launch of each mode of
                a 1-spp regen pass of the cloud (the render's own lanes), its
                ms (median of 5 single-launch windows), the twin's, the
                rounds the twin counts and the bound; that pass's K6 device
                time against its wall; then media-synth at 1000x563, 64
                bounces: fog, cloud and haze through regen (32 spp), fog and
                cloud through lockstep (MEDIA_LOCKSTEP_SPP), forward
                through the crossing-walk branch (MEDIA_FORWARD_SPP), each
                with its launches reset just before and read just after: K3
                and K3-fast launched, K6 in the cloud's only, lockstep's
                counts as in phase 5b, the forward branch's as in phase 9
                with two crossing walks a bounce (the volume NEE's and the
                surface NEE's); each image finite and non-negative; wall,
                Mpaths/s, iterations and launches of each.
  13. bdpt    - the light tracer and BDPT: small-box's LT (4 spp), BDPT (4)
                and BDPT pyramid (2; its 26 (s, t) images summing to the
                render within 1e-5) and small-media fog's LT and BDPT
                against tests/data/torch_port_bdpt_ref.json (numpy BVH
                build), K3 and K3-fast launched, no twin; small-box's LT
                rendered twice at one seed, bit for bit equal; box-synth
                (materialtest-synth's ball and cube in the closed box, lit
                by one ceiling quad) at 1000x563 through the CLI in process
                (tungsten_tpu_torch.tools.tungsten.main) under light_tracer
                (BOX_LT_SPP = 4), bidirectional_path_tracer (BOX_BDPT_SPP =
                2; K = 16 vertices, the JAX cap, with its warning) and
                path_tracer (regen, 32 spp), each with its launches reset
                just before and read just after (K3 and K3-fast only), its
                render's wall and Mpaths/s; on the pixels the path tracer
                shows between 0.01 and 0.5 (tests/test_path_tracer.py:145)
                LT's channel means within 6% of PT's, BDPT's median
                per-pixel ratio to PT within 0.03 of 1 and its means within
                5% (:148, :170-171); then one profile window of a single
                BDPT pass of box-synth: its CUDA kernels and device-busy
                share;
  14. sppm    - SPPM: box-synth at 1000x563 through the CLI in process,
                2^18 photons an iteration (the scene's photon_count), each
                render's launches reset just before and read just after (K3,
                K3-fast and K7, no twin, no v1 kernel), with its wall, K7's
                calls and pairs an iteration and the overflow:
                photon_map (kNN, 20) and progressive_photon_map
                (SPPM_ITERS = 8) held to phase 13's path-traced image by
                the JAX test's median per-pixel ratio (within 0.12 on the
                pixels PT shows in (0.02, 0.5), tests/test_path_tracer.py:
                173-194); the caustic variant (a glass ball, 8) finite and
                non-negative; the fog's four volume photon types
                (SPPM_FOG_ITERS = 4), the median ratio of beams, planes and
                planes_1d to points within 10% of the JAX package's on
                small-box fog at 2^18 photons (which misses the JAX
                tests' 0.2 there: ROADMAP §3); K7
                against its twin bit for bit on the first call of each
                mode in those renders (surface fixed and kNN with its
                histogram, points, beams), timed (median of 5 event
                windows; the twin one call) with its bound; small-box,
                its caustic and its fog (four types) against
                tests/data/torch_port_sppm_ref.json (numpy BVH build) to
                5e-3 with their overflow within 0.1%, and the fog types'
                median ratios to points within 2% of the JAX package's at
                the reference's photon count and at 2^18; then one
                profile window of an SPPM iteration of box-synth.
To make room for phase 8, phase 5b's lockstep render was cut from 32 spp to
8; to make room for phase 9, phase 8's lockstep render from 32 to 16 (at 8
its wavefront check failed, 5.94e-3 against the 5e-3 bar); phase 9's
lockstep renders run 4 spp (coat-synth's 32 kept by regen); to make room
for phase 11, phase 10's lockstep render from 8 to 2; to make room for
phase 12, phase 5b's from 8 to 4, phase 8's from 16 to 12, phase 11's
adaptive passes from 8 to 4 and phase 9's coat-synth profile window from 64
bounces to 8; to make room for phase 13, the numpy-build timing of the gather
pack (phases 3 and 8); to make room for phase 14, phase 8's lockstep render
from 12 spp to 10 and cutout-synth's (phase 9) from 4 to 3.
Every render phase checks that no first CUDA form (v1 kernel) launched.
The kernels line gives, per kernel: the launches of its main path (phase 5's
render for K3, phase 5b's lockstep render for K3-fast, with phase 8's two
renders beside as launches_interior, phase 9's three as
launches_surfaces, phase 10's two as launches_lights, phase 11's as
launches_camera, phase 12's as launches_media and phase 13's box-synth
light tracer and BDPT renders as launches_lt and launches_bdpt and phase
14's SPPM renders as launches_sppm; phase 14's
box-synth progressive_photon_map render for K7, with every SPPM render's
K7 launches beside as launches_sppm, its ms, plain ms and bound on that
render's first surface call and every checked call's under calls (K7 is
XLA loops on the TPU, no pl.pallas_call: its tpu_form; its bound counts
the twin's candidate rows at 14 / 17 / 42 / 96 f32 operations (surface,
hist, points, beams) and 285 a lane-round, the pack and cell tables once,
the pairs written); phase 12's
cloud regen
render for K6, whose ms, plain ms and bound are on the largest tau launch
of the cloud's 1-spp regen pass, the other K6 checks beside; K6 is an XLA
lax.while_loop on the TPU, no pl.pallas_call, which its row's tpu_form
says, and its bound counts the twin's rounds at 2 Gauss nodes x 8 corners
x 4 bytes and 210 f32 operations a round; phase 7's route
renders for K1, K5-v2 and K2, the benchmark for K4, K5-v1 and the first forms),
the largest |t| difference against its twin (the 2N batch for K3, K3-fast,
K4 in its three modes, K5, K2 and the first forms),
and the kernel's and twin's ms and the kernel's bound on the rays of those
launches: the 2N batch for K3, K3-fast, K1, K5-v2 and K2 (K1's ms the mean
of its turns against exact K3, whose time is beside as exact_k3_ms, with
the twin's rounds as twin_rounds; K1 is XLA gathers on the TPU, no
pl.pallas_call, which its row's tpu_form says; K5-v2's and K2's ms
the mean of their turns against their first forms; the benchmark's coherent
time beside as bench_ms, the first form's 2N time as v1_ms), the benchmark's
coherent rays for K4, K5-v1 and the first forms (their 2N time and bound
beside as ms_2n and bound_2n_ms; the first form's times of K5-v1 and of K4
in each mode as v1_ms and v1_ms_2n). The bound is the larger of the
bytes the kernel must move (inputs read once, outputs written once) over
3.35 TB/s and the operations its rays need over the peak rate of their type
(f32 at 67 TFLOP/s; K3-fast's products of bf16 pairs with their f32 sums at
the bf16 matrix rate, 989 TFLOP/s; H100 SXM data sheet), counted on the same
rays at the OPS costs below: box and triangle tests by the twin (K1's
node rounds at 8 slab tests, its leaf rounds at 8 Moller-Trumbore tests);
for K2 the chunk boxes, the sub-boxes of the chunks each ray's box hits and its
Moller-Trumbore tests of the real triangles of the sub-boxes it hits, each
charged to the stage where the test ends (`intersect_stream.sub_box_work`),
with the chunk-level bound of earlier PRs beside as bound_chunk_ms. A first
form's bound is its new kernel's. No single PyTorch call computes a BVH walk
or a brute-force closest hit, so library_ms is null.
K3's, K3-fast's and their v1 forms' ms are the mean of the two turns of
phase 3 (K3, mixed) and 3d (K3-fast, closest), each turn the median of 5
single-launch event windows; back_to_back_ms beside them is the mean of 10
launches back to back in one event window, the measure K3's and K3-fast's ms
took while they were the one-thread-per-ray kernels, kept so that their
series stays continuous. The benchmark's ms are its median of 5
single-launch windows.
The first forms' rows (bvh8_walk_v1, bvh8_walk_fast_v1,
bvh2_walk_v1_ordered, bvh2_walk_v1_skip, bvh2_walk_v1_any, bvh_walk_v1_form,
intersect_stream_v1; "v1" means the first CUDA form, and bvh_walk_v1 is the
TPU's K5-v1, prune=0, on the new kernel) take their launches, ms and bound
from the benchmark (phase 6), with their 2N turn times beside (ms_2n; K3's
and K3-fast's also back_to_back_ms_2n).
It needs nvcc and one CUDA card, no network and no JAX. The last line is the
JSON result; the line before it the card's name and power limit.
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BAR = 0.999  # prim / occlusion agreement, kernel vs twin and vs brute force
# t where prim agrees: >= 99.9% of hits within rtol 1e-5 plus an absolute
# floor of 1e-6 per unit of scene extent, all within rtol 1e-3. The plane
# form's numerator N.o + nc cancels to the point-plane distance, so its error
# is absolute (~eps * |o|) and grows as 1 / |cos| on grazing hits; the kernel
# fuses multiply-adds where the twin does not.
T_RTOL, T_ATOL_PER_EXTENT, T_RTOL_ALL = 1e-5, 1e-6, 1e-3
# the repair launch's live lanes are the grazing ones (a phantom lies just
# outside a silhouette edge), many of them shadow lanes that hit at t of a few
# tnear: there a relative bar has no meaning, and the absolute error
# (~eps * |o| / |cos|, |cos| down to ~1e-2) gets its own floor on the
# all-lanes bar, per unit of scene extent. The same floor holds K3-fast's
# tensor-core sums against its twin's fixed order on the 2N batch's grazing
# shadow lanes, and K4's rounded leaf sums against its twin's and its first
# form's on those lanes
T_ATOL_ALL_GRAZING_PER_EXTENT = 1e-4
MEAN_RTOL = 5e-3  # render per-channel means vs the JAX package's, and route vs route
# routes: a hit that flips between two walks reshades the rest of its path
PIX_ATOL, PIX_RTOL, PIX_BAR = 1e-3, 1e-3, 0.90
# the K4 walks: (json name, benchmark name, mode, source, the TPU kernel it
# replaces)
NEW_KERNELS = (
    ("bvh2_walk_ordered", "bvh3", "ordered", "tungsten_tpu_torch/csrc/bvh2_walk.cu",
     "tungsten_tpu/ops/pallas_bvh2.py:204"),
    ("bvh2_walk_skip", "bvh3skip", "skip", "tungsten_tpu_torch/csrc/bvh2_walk.cu",
     "tungsten_tpu/ops/pallas_bvh2.py:126"),
    ("bvh2_walk_any", "bvh3any", "any", "tungsten_tpu_torch/csrc/bvh2_walk.cu",
     "tungsten_tpu/ops/pallas_bvh2.py:168"),
)
# K4's slot vs exact K3's (coincident triangles may tie across leaves), and
# K4-any's occlusion vs K3's latch
K4_K3_BAR = 0.9999
# K5 in both modes and K2, each with its first CUDA form: (json name,
# benchmark name, source, the TPU kernel it replaces, the first form's json
# name and benchmark name, or None where the first form's row is another
# mode's)
K5_K2 = (
    ("bvh_walk", "bvh", "tungsten_tpu_torch/csrc/bvh_walk.cu",
     "tungsten_tpu/ops/pallas_bvh.py:298", "bvh_walk_v1_form", "bvhv1"),
    ("bvh_walk_v1", "bvh1", "tungsten_tpu_torch/csrc/bvh_walk.cu",
     "tungsten_tpu/ops/pallas_bvh.py:51", None, "bvh1v1"),
    ("intersect_stream", "tri", "tungsten_tpu_torch/csrc/intersect_stream.cu",
     "tungsten_tpu/ops/pallas_intersect.py:41", "intersect_stream_v1", "triv1"),
)
K2_BAR = 0.9999  # K2's prim vs its twin: the per-ray sub-box cull against the tile vote
# the bound: f32 operations per test (adds, multiplies, min / max, compares,
# divides, each one): a slab test against one box, a plane-form slot
# (bvh8_walk.cu's leaf), a Moller-Trumbore slot (bvh_walk.cu, intersect_stream.cu)
# a bf16x3 plane slot (bvh8_walk_fast.cu's leaf) is 123, of two types. 108
# are the products of bf16 pairs and their f32 sums, the work the TPU kernel
# gives its matrix unit: six three-pass products of (3 x 5 for the dot
# products) + 2 to join the passes, + 2 for the affine w on three of them;
# they are held to the card's bf16 matrix rate. 15 are plain f32: t (negate,
# divide) 2; u and v (multiply, add) 4; u + v 1; five compares 5; the
# winner's compare and select 3.
# A Moller-Trumbore slot by the stage at which walk_common.cuh's `mt_exact`
# leaves it (intersect_stream.MT_STAGES, counted for K2 by sub_box_work):
# p = d x e2 and det 14, |det| > eps 2 -> 16; tv 3, u's numerator 5, its
# sign 1 -> 25; q = tv x e1 9, v's numerator 5, its sign 1 -> 40; t's
# numerator 5, its sign 1 -> 46; the reciprocal 1, three products 3, u + v
# 1, u + v <= 1, t > tnear, t < lim 3 -> 54, the whole test ("mt", which K5's
# bound charges every slot: an upper count, since its leaves reject early too)
OPS = {"box": 25, "plane": 45, "mt": 54, "plane_bf16x3_mma": 108, "plane_bf16x3": 15,
       "mt_det": 16, "mt_u": 25, "mt_v": 40, "mt_t": 46, "mt_full": 54}
FAST_BAR = 0.9999  # fast query vs exact query, prim
# lockstep vs regen, full width: two estimators of one integral, 18M paths each
WAVEFRONT_RTOL = 5e-3
# phase 5b's lockstep render, cut from the scene's 32 spp to make room for
# phase 8 (its regen render keeps 32), and from 8 to 4 for phase 12 (the
# two wavefronts' means stood 6.19e-4 apart at 8 spp on an H100, against a
# bar of 5e-3)
AREA_LOCKSTEP_SPP = 4
# the interior cell's BSDF types that phase 8 must see hit, JAX type ids
INTERIOR_TYPES = {1: "null", 2: "mirror", 7: "dielectric", 8: "rough_dielectric",
                  9: "conductor", 10: "plastic", 11: "rough_plastic"}
# phase 8's lockstep render, cut from the scene's 32 spp to make room for
# phase 9 (its regen render keeps 32; on an H100 the two wavefronts' means
# stood 2.04e-3 apart at 16 spp, 2.2e-3 at 32, 5.94e-3 at 8: the bar is
# 5e-3), from 16 to 12 to make room for phase 12, and from 12 to 10 for
# phase 14 (2.19e-3 apart at 10)
INTERIOR_LOCKSTEP_SPP = 10
# the surface scenes' BSDF types that phase 9 must see hit, JAX type ids
SURFACE_TYPES = {"coat-synth": {4: "smooth_coat", 5: "oren_nayar", 6: "phong", 15: "mixed",
                                16: "diffuse_transmission", 17: "rough_coat"},
                 "cutout-synth": {12: "thinsheet", 13: "transparency", 14: "forward"}}
# phase 9's lockstep renders, 4 spp (coat-synth's regen render keeps the
# scene's 32): at 8 spp the script took 469 s on an H100 machine, and a host
# 1.3-1.6x slower (as one has measured) would pass the 600 s the script
# keeps under; cutout-synth's from 4 to 3 for phase 14
# (not 2 for cutout-synth: a thin sheet's interference reflectance 1 - T
# can round a few ulps below 0, as in the JAX package, and at 2 spp a pixel
# of its image was negative)
# (nor 3 or 2 for coat-synth: on an H100 its two wavefronts' means stood
# 2.33e-3 apart at 4 spp, 1.43e-2 at 3, 3.81e-2 at 2, against a bar of 5e-3)
SURFACE_LOCKSTEP_SPP = {"coat-synth": 4, "cutout-synth": 3}
# the depth of phase 9's profile windows: a regen pass of coat-synth and a
# lockstep pass of cutout-synth (coat's at its 64 bounces took ~60 s of the
# script, ~27 s of them the profiler's own teardown of ~800,000 kernel
# events; cut to make room for phase 12)
PROFILE_BOUNCES = 8
# phase 10's lockstep render of lights-synth (its regen render keeps the
# scene's 32 spp), cut from 8 to 2 to make room for phase 11: the script
# took 593 s with phase 11 and 4 spp here on an H100 machine whose host
# slowed down mid-run
# (every kind is still chosen ~10^4 times; no BSDF of the scene has a
# negative weight)
LIGHTS_LOCKSTEP_SPP = 2
# phase 11: the camera-synth renders' spp (the CLI's takes the scene's 32)
CAMERA_RESUME_SPP = 16  # saved, then resumed to the scene's 32
CAMERA_WARMUP_SPP, CAMERA_ADAPTIVE_PASSES = 16, 4  # passes cut from 8 for phase 12
CAMERA_OTHER_SPP = 16  # equirectangular and cubemap
# H100 SXM data sheet, dense rates: f32 FLOP/s outside the tensor cores, bf16
# FLOP/s on them, HBM3 B/s
F32_PEAK, BF16_PEAK, HBM_RATE = 67e12, 989e12, 3.35e12


T0 = time.time()


def log(msg):
    """A line of output, after the seconds since the script started."""
    print(f"{time.time() - T0:7.1f} {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def t_close(a, b, atol, atol_all=0.0):
    """The t bar above, as one boolean."""
    near = torch.isclose(a, b, rtol=T_RTOL, atol=atol).float().mean().item() >= BAR
    return near and bool(torch.isclose(a, b, rtol=T_RTOL_ALL, atol=atol_all).all())


def counted():
    """Every kernel wrapper and twin that keeps a launch count."""
    from tungsten_tpu_torch.ops import (bvh, bvh2, bvh8, gather_bvh, grid_walk, intersect_stream,
                                        photon_walk)

    return (photon_walk.walk_cuda, photon_walk.walk_twin, grid_walk.walk_cuda, grid_walk.walk_twin,
            bvh8.walk_cuda, bvh8.walk_twin, bvh8.walk_fast_cuda, bvh8.walk_fast_twin,
            bvh8.walk_cuda_v1, bvh8.walk_fast_cuda_v1, bvh2.walk3_cuda, bvh2.walk3_twin,
            bvh2.walk3_cuda_v1,
            bvh.walk_packet_cuda, bvh.walk_packet_twin, bvh.walk_packet_cuda_v1,
            intersect_stream.stream_cuda, intersect_stream.stream_twin,
            intersect_stream.stream_cuda_v1, gather_bvh.walk_cuda, gather_bvh.walk_twin)


def reset_counts():
    """Set every launch count (per mode where a wrapper has modes) to 0."""
    for f in counted():
        f.launches = dict.fromkeys(f.launches, 0) if isinstance(f.launches, dict) else 0


def counts():
    """{"<wrapper>[.<mode>]": launches} over every counted wrapper."""
    out = {}
    for f in counted():
        name = f"{f.__module__.rsplit('.', 1)[-1]}.{f.__name__}"
        if isinstance(f.launches, dict):
            out.update({f"{name}.{m}": v for m, v in f.launches.items()})
        else:
            out[name] = f.launches
    return out


def v1_launches(c):
    """The launches of every first CUDA form (the *_cuda_v1 wrappers) in counts() c."""
    return sum(v for k, v in c.items() if "_cuda_v1" in k)


def bound(n_bytes, ops, bf16_ops=0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (f32, plus bf16 products
    with f32 sums at the matrix rate)."""
    t_bytes = n_bytes / HBM_RATE * 1e3
    t_ops = (ops / F32_PEAK + bf16_ops / BF16_PEAK) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def agree(a, b):
    return (a == b).float().mean().item()


def median_ms(fn, reps=5):
    """Median of `reps` single-launch CUDA-event windows, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


TURNS = {}  # label -> (v1 ms, new ms): every timing in turns of the run


def turns(label, fn_old, fn_new, card, names=("v1", "new")):
    """A v1 kernel and its new form (or two kernels `names`) timed in turns
    (v1, new, new, v1), each turn the median of 5 launches; each kernel's
    time is the mean of its two turns."""
    t = [median_ms(f) for f in (fn_old, fn_new, fn_new, fn_old)]
    old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    TURNS[label] = (old_ms, new_ms)
    a, b = names
    log(f"  turns {label} on {card}: {a} {t[0]:.4f} / {t[3]:.4f} ms, {b} {t[1]:.4f} / "
        f"{t[2]:.4f} ms -> {a} {old_ms:.4f}, {b} {new_ms:.4f} ({old_ms / new_ms:.2f}x)")
    return old_ms, new_ms


def same_bits(a, b):
    """Two walks' outputs, (t, local) or (t, slot or prim, u, v), equal bit
    for bit."""
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32)) if x.is_floating_point()
        else torch.equal(x, y) for x, y in zip(a, b))


def fast_bars(label, tk, lk, tt, lt, t_atol, atol_all):
    """The fast kernel against a bit-exact reference (its twin or v1): the
    raw slot on >= BAR of the lanes; where the slots agree, t within rtol
    T_RTOL plus t_atol on >= BAR and within rtol T_RTOL_ALL plus atol_all on
    all (the grazing floor: the two sum N.o + nc in different orders, and
    the difference grows as 1 / |cos|). Returns the largest |t| difference
    there."""
    check(agree(lk, lt) >= BAR, f"K3-fast {label}: raw slot agree {agree(lk, lt):.6f} (>= {BAR})")
    same = (lk == lt) & (lk >= 0)
    err = (tk[same] - tt[same]).abs().max().item() if bool(same.any()) else 0.0
    near = torch.isclose(tk[same], tt[same], rtol=T_RTOL, atol=t_atol).float().mean().item()
    check(t_close(tk[same], tt[same], t_atol, atol_all), f"K3-fast {label}: t within rtol "
          f"{T_RTOL} atol {t_atol:.2g} on {near:.6f} (>= {BAR}), rtol {T_RTOL_ALL} atol "
          f"{atol_all:.2g} (all); max abs err {err:.3e}")
    return err


def k4_bars(label, out, ref, t_atol, atol_all):
    """A K4 walk against a reference (its twin or its first form): the slot
    on >= BAR of the lanes, the lanes that differ counted and printed, and
    the t bar where the slots agree (atol_all: the all-lanes floor).
    Returns the largest |t| difference there."""
    (tk, lk), (tr, lr) = out, ref
    same = lk == lr
    check(agree(lk, lr) >= BAR, f"{label}: slot agree {agree(lk, lr):.6f} (>= {BAR}); "
          f"{int((~same).sum())} lanes differ: {int((~same & (lk < 0)).sum())} the kernel "
          f"missed, {int((~same & (lr < 0)).sum())} the reference missed, "
          f"{int((~same & (lk >= 0) & (lr >= 0)).sum())} another slot")
    hit = same & (lk >= 0)
    err = (tk[hit] - tr[hit]).abs().max().item()
    check(t_close(tk[hit], tr[hit], t_atol, atol_all), f"{label}: t within rtol {T_RTOL} atol "
          f"{t_atol:.2g} (>= {BAR}), rtol {T_RTOL_ALL} atol {atol_all:.2g} (all); max abs err "
          f"{err:.3e}")
    return err


def build_native_bvh():
    """Start the host's BVH builder (native/bvh_builder.cpp, which the
    flatten uses where native/libtungsten_native.so exists: seconds, not
    the numpy build's ~10 s for an 80,000-triangle scene) with portable
    flags, so that every host builds the same trees; returns a function that
    waits for it and logs the result. A failed build leaves the numpy
    build, which gives other valid trees (host time only)."""
    from tungsten_tpu_torch.accel import bvh as accel_bvh

    lib = os.path.join(REPO, "native", "libtungsten_native.so")
    if os.path.exists(lib):
        return lambda: log(f"[2 build] {lib} present: the flatten's BVH builder")
    t0 = time.time()
    proc = subprocess.Popen(["make", "-C", os.path.join(REPO, "native"),
                             "CXXFLAGS=-O3 -fPIC -std=c++17"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        out, _ = proc.communicate()
        accel_bvh._NATIVE = None  # loaded at the next build
        log(f"[2 build] native BVH builder: make exit {proc.returncode} in "
            f"{time.time() - t0:.2f} s{'' if proc.returncode == 0 else ': ' + out[-500:]}")

    return wait


@contextlib.contextmanager
def numpy_bvh_build():
    """The small reference renders use the numpy BVH build, as the JAX
    package's references did (the native BVH build, where a checkout has made
    it, gives another valid tree and so another triangle order)."""
    from tungsten_tpu_torch.accel import bvh as accel_bvh

    saved, accel_bvh._NATIVE = accel_bvh._NATIVE, False
    try:
        yield
    finally:
        accel_bvh._NATIVE = saved


def gbvh_cost(label, scene, flatten_s):
    """What the gather pack (gbvh, K1's) adds to a flatten: build_gather_pack
    on the scene's triangles, timed on the flatten's BVH build (its time on
    the numpy build, ~8 s a scene, went to make room for phase 13)."""
    from tungsten_tpu_torch.ops.gather_bvh import build_gather_pack

    tris = [x.cpu().numpy() for x in (scene.tris.v0, scene.tris.e1, scene.tris.e2)]
    t0 = time.time()
    build_gather_pack(*tris)
    native_s = time.time() - t0
    log(f"[{label}] gbvh: build_gather_pack {native_s:.3f} s of the load and flatten's "
        f"{flatten_s:.3f} s (without it {flatten_s - native_s:.3f} s)")


def check_lockstep_launches(label, n_fast, n_exact, passes, max_bounces):
    """A lockstep render's walk launches: per pass one camera walk and one
    2N walk per bounce run, each with its repair launch, and one shadow walk
    per bounce run; returns the bounces run."""
    bounces = n_fast - passes
    check(passes <= bounces <= passes * max_bounces and n_exact == n_fast + bounces,
          f"{label}: {passes} passes ran {bounces} bounces ({bounces / passes:.1f} a pass): "
          f"{n_fast} = passes + bounces fast launches, {n_exact} = repairs + shadow walks "
          f"exact launches")
    return bounces


def check_forward_launches(label, n_fast, n_exact, calls, passes, max_bounces,
                           walks_per_bounce=1):
    """A lockstep render through the forward-lobe branch: per bounce one
    path walk, and where NEE runs one 2N crossing walk of 1 to MAX_CROSSINGS
    closest-hit steps (with media two: the volume NEE's and the surface
    NEE's, walks_per_bounce); every closest-hit walk is a fast launch with
    its repair launch, and no shadow walk runs. `calls` holds the bounces
    (shading) and crossing walks counted by `tracer_calls`."""
    from tungsten_tpu_torch.integrators.path_tracer import MAX_CROSSINGS

    bounces, walks = calls["shading"], calls["crossing"]
    steps = n_fast - bounces
    check(n_exact == n_fast and passes <= bounces <= passes * max_bounces
          and walks <= walks_per_bounce * bounces and walks <= steps <= walks * MAX_CROSSINGS,
          f"{label}: {passes} passes ran {bounces} bounces ({bounces / passes:.1f} a pass) and "
          f"{walks} crossing walks of {steps} steps ({steps / max(walks, 1):.2f} a walk): "
          f"{n_fast} = bounces + steps fast launches, {n_exact} repair launches")
    return bounces


@contextlib.contextmanager
def tracer_calls():
    """Counts, while open, of the path tracer's once-an-iteration calls:
    "shading" (`_shading_data`: one a regen iteration or a lockstep bounce)
    and "crossing" (`_trace_transparent`: one 2N crossing walk a forward
    bounce that runs NEE)."""
    from tungsten_tpu_torch.integrators import path_tracer as pt

    out = {"shading": 0, "crossing": 0}
    saved = pt._shading_data, pt._trace_transparent

    def shading(*a):
        out["shading"] += 1
        return saved[0](*a)

    def crossing(*a):
        out["crossing"] += 1
        return saved[1](*a)

    pt._shading_data, pt._trace_transparent = shading, crossing
    try:
        yield out
    finally:
        pt._shading_data, pt._trace_transparent = saved


def profile_window(label, fn, card, tag="9 profile", iterations=None):
    """fn() timed bare, then again under torch.profiler with CUDA activity
    only (host-side op records would slow the host-bound loop the window
    measures): the CUDA kernels launched per iteration (per `_shading_data`
    call), the device-busy share (the union of the device's activity
    intervals over the window's wall, under the profiler and over the bare
    wall), and the five kernel names of most device time. The device events
    are read from the profiler's raw results: building its Python event tree
    for ~10^6 kernels took minutes. `iterations`: what fn runs (a BDPT
    pass: 1), where `_shading_data`'s calls do not count it. Returns a dict
    of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    with tracer_calls() as calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    spans, by_name, kernels = [], {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        spans.append((e.start_ns(), e.end_ns()))
        n, ns = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, ns + e.duration_ns())
        low = name.lower()
        kernels += "memcpy" not in low and "memset" not in low
    busy, end = 0, -1
    for a, b in sorted(spans):  # the union of the intervals, ns
        if b > end:
            busy += b - max(a, end)
            end = b
    iters = iterations or max(calls["shading"], 1)
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:5]
    out = {"iterations": iterations or calls["shading"], "wall_s": wall, "bare_wall_s": bare,
           "device_busy_s": busy / 1e9, "busy_share": busy / 1e9 / wall,
           "busy_share_of_bare_wall": busy / 1e9 / bare, "kernels": kernels,
           "kernels_per_iteration": kernels / iters,
           "top5": [[k[:120], n, round(ns / 1e6, 4)] for k, (n, ns) in top],
           "read_s": time.perf_counter() - t0}
    log(f"[{tag}] {label} on {card}: {json.dumps(out)}")
    check(bool(spans), f"{label}: the profiler saw the device's activity")
    return out


def k3_only(label, c):
    """K3 and K3-fast launched, no other walk, twin or v1 kernel, in the
    counts c of one render."""
    others = {k: v for k, v in c.items()
              if k not in ("bvh8.walk_cuda", "bvh8.walk_fast_cuda") and v}
    check(c["bvh8.walk_cuda"] > 0 and c["bvh8.walk_fast_cuda"] > 0 and not others,
          f"{label}: K3 launched {c['bvh8.walk_cuda']} times, K3-fast "
          f"{c['bvh8.walk_fast_cuda']}, every other walk, twin and v1 kernel none {others}")


def render_vs_ref(label, path, ref_file, dev, wavefront="auto"):
    """render_scene of a small scene against the JAX package's channel
    means; K3 and K3-fast must launch and no twin."""
    from tungsten_tpu_torch.renderer.render import render_scene

    with open(os.path.join(REPO, "tests", "data", ref_file)) as f:
        ref = json.load(f)
    want = ref["channel_means"] if wavefront == "auto" else ref["channel_means"][wavefront]
    name = f"{ref['scene']} ({wavefront})"
    log(f"[{label}] render_scene of the {name} scene")
    reset_counts()
    hdr, _ = render_scene(path, dev, seed=ref["seed"], wavefront=wavefront)
    c = counts()
    twins = sum(v for k, v in c.items() if "twin" in k)
    v1 = v1_launches(c)
    check(c["bvh8.walk_cuda"] > 0 and c["bvh8.walk_fast_cuda"] > 0 and twins == 0 and v1 == 0,
          f"{name}: K3 launches {c['bvh8.walk_cuda']}, K3-fast "
          f"{c['bvh8.walk_fast_cuda']}, twins {twins}, v1 kernels {v1}")
    check(np.isfinite(hdr).all() and (hdr >= 0).all(), f"{name}: image finite and non-negative")
    means = hdr.reshape(-1, 3).astype(np.float64).mean(0)
    rel = np.abs(means - want) / np.abs(want)
    check((rel <= MEAN_RTOL).all(), f"{name}: channel means {means.round(6).tolist()} vs "
          f"JAX {np.round(want, 6).tolist()} (rel {rel.max():.2e} <= {MEAN_RTOL})")


def k1_phase(scene, sets, r2, latch, sub, hb, n_pix, card):
    """Phase 3e: K1 (gather_walk.cu) on the materialtest-synth gbvh pack.
    `sets` are phase 3's (label, rays, mixed latch mask): the random rays,
    the camera rays and the 2N batch. Returns the K1 row's numbers."""
    from tungsten_tpu_torch.ops import bvh8, gather_bvh

    gp, pack = scene.gbvh, scene.pbvh8
    log(f"[3e K1] the gather walk on materialtest-synth: {gp.n_rows} rows of {gather_bvh.ROW} "
        f"floats, depth {gp.depth} (bitstack {gp.depth + 2} of {gather_bvh.MAX_LEVELS} levels)")
    reset_counts()
    for label, rr, lanes in sets:
        for mode, lat in (("closest", None), ("latched", True), ("mixed", lanes)):
            out = gather_bvh.walk_cuda(gp, *rr, lat)
            torch.cuda.synchronize()
            t0 = time.time()
            twin = gather_bvh.walk_twin(gp, *rr, lat)
            torch.cuda.synchronize()
            check(same_bits(out, twin), f"K1 {label} {mode}: t, prim, u and v equal the twin's "
                  f"bit for bit (prim agree {agree(out[1], twin[1]):.6f}, hits "
                  f"{(out[1] >= 0).float().mean().item():.4f}; twin {time.time() - t0:.1f} s, "
                  f"{gather_bvh.walk_twin.work})")
    c = counts()
    check(c["gather_bvh.walk_cuda"] == c["gather_bvh.walk_twin"] == 3 * len(sets),
          f"K1 and its twin launched {c['gather_bvh.walk_cuda']} / {c['gather_bvh.walk_twin']} "
          f"times")
    hk = gather_bvh.intersect_bvh_gather(gp, *sub)
    check(agree(hk.prim, hb.prim) >= BAR, f"K1 8192 rays: query vs brute force prim agree "
          f"{agree(hk.prim, hb.prim):.6f} (>= {BAR})")
    # against exact K3 on the 2N batch: the closest-hit lanes by prim, the
    # latched lanes by occlusion (the walks reach different first hits)
    h1 = gather_bvh.intersect_bvh_gather_mixed(gp, *r2, latch)
    h3 = bvh8.intersect_mixed(pack, scene.tris, *r2, latch)
    closest = ~latch
    same = h1.prim[closest] == h3.prim[closest]
    check(same.float().mean().item() >= BAR, f"K1 vs exact K3, 2N closest-hit lanes: prim "
          f"agree {same.float().mean().item():.6f} (>= {BAR}); {int((~same).sum())} lanes "
          f"differ")
    occ = (h1.prim[latch] >= 0) == (h3.prim[latch] >= 0)
    check(occ.float().mean().item() >= K4_K3_BAR, f"K1 vs K3's latch, 2N latched lanes: "
          f"occlusion agree {occ.float().mean().item():.6f} (>= {K4_K3_BAR}); "
          f"{int((~occ).sum())} lanes differ")
    k3_ms, k1_ms = turns("K3 vs K1 2N mixed", lambda: bvh8.walk_cuda(pack, *r2, latch),
                         lambda: gather_bvh.walk_cuda(gp, *r2, latch), card, ("K3", "K1"))
    twin_out = gather_bvh.walk_twin(gp, *r2, latch)
    work = dict(gather_bvh.walk_twin.work)
    plain_ms = cuda_ms(lambda: gather_bvh.walk_twin(gp, *r2, latch), reps=1)
    k1_bytes = nbytes(*r2, latch, gp.rows) + 16 * r2[0].shape[0]  # t, prim, u, v out
    k1_ops = work["node"] * 8 * OPS["box"] + work["leaf"] * 8 * OPS["mt"]
    err = (twin_out[0] - h1.t).abs()[(h1.prim >= 0) & closest].max().item()
    log(f"[3e K1] 2N={2 * n_pix} mixed on {card}: K1 {k1_ms:.3f} ms, exact K3 {k3_ms:.3f} ms, "
        f"twin {plain_ms:.3f} ms; twin rounds {work}")
    return dict(ms=k1_ms, k3_ms=k3_ms, plain_ms=plain_ms, bytes=k1_bytes, ops=k1_ops,
                err=err, work=work)


def lights_phase(work, dev, card):
    """Phase 10: the lights. small-lights in both wavefronts against
    tests/data/torch_port_lights_ref.json (numpy BVH build); lights-synth at
    full width through regen (its 32 spp) and lockstep (LIGHTS_LOCKSTEP_SPP),
    each counting the light rows NEE chose: every light kind must be chosen.
    Returns {render: counts()}."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.integrators.path_tracer import count_light_choices
    from tungsten_tpu_torch.models.primitives.lights import light_kinds
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    paths = {size: synth.write_scene(os.path.join(work, size), size)
             for size in ("small-lights", "lights-synth")}
    with numpy_bvh_build():
        for wavefront in ("regen", "lockstep"):
            render_vs_ref("10 lights", paths["small-lights"], "torch_port_lights_ref.json", dev,
                          wavefront)
    t0 = time.time()
    sc = flatten_scene(load_scene(paths["lights-synth"]), dev)
    m = sc.meta
    kinds = light_kinds(sc)
    log(f"[10 lights] lights-synth flattened in {time.time() - t0:.1f} s: "
        f"{sc.tris.v0.shape[0]} triangles, {sc.ana.n} analytic prims, {m.n_lights} lights "
        f"{kinds}, envs {m.n_envs}, caps {m.n_caps} (escape {m.esc_caps}); "
        f"{m.res_x}x{m.res_y}, {m.spp} spp, max_bounces {m.max_bounces}")
    means, launches = {}, {}
    for wavefront in ("regen", "lockstep"):
        spp = m.spp if wavefront == "regen" else LIGHTS_LOCKSTEP_SPP
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with count_light_choices(dev) as chosen:
            img = render_flat(sc, spp=spp, seed=DEFAULT_SEED, wavefront=wavefront)
        dt = time.time() - t0
        label = f"lights-synth {wavefront}"
        by_kind = {}
        for i, n in chosen.items():
            by_kind[kinds[i]] = by_kind.get(kinds[i], 0) + n
        log(f"[10 lights] light choices of the {label} render ({spp} spp): "
            + json.dumps({f"{i} {kinds[i]}": n for i, n in sorted(chosen.items())}))
        check(set(chosen) == set(range(m.n_lights)) and set(by_kind) == set(kinds),
              f"{label}: NEE chose every light row, each kind {by_kind}")
        c = launches[label] = counts()
        k3_only(label, c)
        if wavefront == "lockstep":
            check_lockstep_launches(label, c["bvh8.walk_fast_cuda"], c["bvh8.walk_cuda"], spp,
                                    m.max_bounces)
        check(img.shape == (m.res_y, m.res_x, 3) and np.isfinite(img).all()
              and (img >= 0).all(), f"{label}: {img.shape} image finite and non-negative")
        means[wavefront] = img.reshape(-1, 3).astype(np.float64).mean(0)
        log(f"[10 lights] {label}: {m.res_x}x{m.res_y} {spp} spp in {dt:.2f} s: "
            f"{m.res_x * m.res_y * spp / dt / 1e6:.4f} Mpaths/s on {card}; channel means "
            f"{means[wavefront].round(6).tolist()}")
    rel = np.abs(means["lockstep"] - means["regen"]) / np.abs(means["regen"])
    log(f"[10 lights] lights-synth: lockstep's channel means vs regen's, rel {rel.max():.3e} "
        f"({LIGHTS_LOCKSTEP_SPP} against {m.spp} spp)")
    return launches


@contextlib.contextmanager
def timed_renders(name="render_buffers"):
    """Times, while open, each call the CLI makes of the render driver
    `name` (render_buffers, render_light_traced, render_bdpt): a list of
    (seconds, its result), the device synchronised at the end."""
    from tungsten_tpu_torch.renderer import render

    out, saved = [], getattr(render, name)

    def timed(*a, **k):
        t0 = time.time()
        bufs = saved(*a, **k)
        torch.cuda.synchronize()
        out.append((time.time() - t0, bufs))
        return bufs

    setattr(render, name, timed)
    try:
        yield out
    finally:
        setattr(render, name, saved)


def camera_phase(work, dev, card):
    """Phase 11: the cameras, filters, AOVs, the driver and the CLI.
    Returns {render: counts()} of its full-width renders."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.renderer.framebuffer import OutputBuffers, scene_hash
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_buffers
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene
    from tungsten_tpu_torch.tools import tungsten as cli

    with open(os.path.join(REPO, "tests", "data", "torch_port_camera_ref.json")) as f:
        ref = json.load(f)
    with numpy_bvh_build():
        for variant, want in ref["variants"].items():
            path = synth.write_scene(os.path.join(work, f"small-camera-{variant}"),
                                     "small-camera", variant)
            scene = flatten_scene(load_scene(path), dev)
            for wavefront in ("regen", "lockstep"):
                name = f"small-camera {variant} ({wavefront})"
                reset_counts()
                bufs = render_buffers(scene, seed=ref["seed"], wavefront=wavefront)
                k3_only(name, counts())
                img = bufs.color()
                check(np.isfinite(img).all() and (img >= 0).all(),
                      f"{name}: image finite and non-negative")
                means = img.reshape(-1, 3).astype(np.float64).mean(0)
                rel = np.abs(means - want["channel_means"][wavefront]) / np.abs(
                    want["channel_means"][wavefront])
                aov_rel = {}
                for k, b in want["aov_means"][wavefront].items():
                    a = bufs.aov(k).reshape(-1, len(b)).astype(np.float64).mean(0)
                    aov_rel[k] = float(np.abs(a - b).max() / np.abs(b).max())
                check((rel <= MEAN_RTOL).all() and all(r <= MEAN_RTOL for r in aov_rel.values())
                      and sorted(aov_rel) == sorted(bufs.aovs),
                      f"{name}: channel means {means.round(6).tolist()} vs JAX (rel "
                      f"{rel.max():.2e}), AOV means rel {aov_rel} (<= {MEAN_RTOL})")

    launches = {}
    paths = {v: synth.write_scene(os.path.join(work, f"camera-synth-{v}"), "camera-synth", v)
             for v in ("thinlens", "equirectangular", "cubemap")}
    path = paths["thinlens"]
    with open(path) as f:
        doc = json.load(f)
    # the uniform render (Tungsten's renderer samples adaptively by default),
    # its state kept for the resume check
    doc["renderer"].update(adaptive_sampling=False, enable_resume_render=True,
                           resume_render_file="cli.state")
    with open(path, "w") as f:
        json.dump(doc, f)
    out_dir = os.path.dirname(path)
    state = os.path.join(out_dir, "cli.state")
    if os.path.exists(state):
        os.remove(state)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with timed_renders() as renders:
        cli.main([path, "-q"])
    wall = time.time() - t0
    c = launches["thinlens CLI (regen)"] = counts()
    k3_only("camera-synth thinlens CLI", c)
    (dt, straight), = renders
    h, w = straight.res
    spp = int(straight.count.max())
    log(f"[11 camera] CLI on camera-synth thinlens (blade aperture, cat-eye, focus pivot, "
        f"mitchell_netravali, AOVs): {w}x{h} {spp} spp, render {dt:.2f} s: "
        f"{w * h * spp / dt / 1e6:.4f} Mpaths/s on {card}; the whole CLI (load, flatten, "
        f"render, write) {wall:.2f} s")
    files = {k: os.path.join(out_dir, f) for k, f in (
        ("ldr", "thinlens_ldr.pfm"), ("hdr", "thinlens.pfm"),
        *((f"{a}_{e}", f"thinlens_{a}{'_ldr' if e == 'ldr' else ''}.pfm")
          for a in ("depth", "normal", "albedo") for e in ("ldr", "hdr")))}
    check(all(os.path.exists(f) for f in files.values()) and os.path.exists(state),
          f"CLI: wrote {sorted(os.path.basename(f) for f in files.values())} and its state")
    hdr, normal, depth, albedo = (load_image(files[k]) for k in (
        "hdr", "normal_hdr", "depth_hdr", "albedo_hdr"))
    check(hdr.shape == (h, w, 3) and np.isfinite(hdr).all() and (hdr >= 0).all()
          and spp == 32 and (straight.count == spp).all(),
          f"CLI: {hdr.shape} image finite and non-negative, {spp} spp everywhere")
    # the ball (albedo 1) at the centre, the focus pivot: a pixel's albedo is
    # the share of its samples that recorded (the cat-eye vignettes the
    # rest), and its normal that share of a unit normal
    cy, cx = h // 2, w // 2
    centre = (slice(cy - 8, cy + 8), slice(cx - 8, cx + 8))
    unit = np.linalg.norm(normal[centre], axis=-1) / albedo[centre].mean(-1)
    check(np.linalg.norm(normal, axis=-1).max() <= 1.0 + 1e-4 and (albedo[centre] > 0).all()
          and np.abs(unit - 1.0).max() < 0.02 and (depth[centre] > 0).all(),
          f"CLI: AOVs plausible: at the ball's centre the normals {unit.min():.5f}-"
          f"{unit.max():.5f} long, the share of samples recorded "
          f"{albedo[centre].mean(-1).min():.3f}-{albedo[centre].mean(-1).max():.3f}, depth "
          f"{depth[centre][..., 0].min():.4f}-{depth[centre][..., 0].max():.4f} of its maximum")

    # resume: CAMERA_RESUME_SPP saved, then resumed to the CLI's spp, equals
    # the CLI's straight render (its state file) bit for bit
    scene = flatten_scene(load_scene(path), dev)
    sh = scene_hash(load_scene(path))
    part = os.path.join(out_dir, "part.state")
    if os.path.exists(part):
        os.remove(part)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    render_buffers(scene, spp=CAMERA_RESUME_SPP, passes_per_batch=16, resume_file=part,
                   scene_hash_value=sh)
    resumed = render_buffers(scene, spp=spp, passes_per_batch=16, resume_file=part,
                             scene_hash_value=sh)
    dt = time.time() - t0
    launches["thinlens resume (regen)"] = counts()
    k3_only("camera-synth thinlens resume", launches["thinlens resume (regen)"])
    saved = OutputBuffers(w, h, aovs=tuple(straight.aovs))
    check(saved.load_state(state, sh) == {"next_pass": spp}, "CLI: its state file loads")
    arrays = ("sum", "count", "sum_a", "sum_b", "count_a", "count_b", "mean", "m2", "aov_count")
    same = {k: bool(np.array_equal(getattr(resumed, k), getattr(saved, k))) for k in arrays}
    same.update({f"{g} {k}": bool(np.array_equal(getattr(resumed, g)[k], getattr(saved, g)[k]))
                 for g in ("aovs", "aovs_a", "aovs_b") for k in resumed.aovs})
    check(all(same.values()) and resumed.passes == saved.passes == 2,
          f"resume: {CAMERA_RESUME_SPP} spp saved, resumed to {spp}, equals the straight "
          f"render bit for bit {same}; {w * h * spp / dt / 1e6:.4f} Mpaths/s ({dt:.2f} s)")

    # adaptive: one regen batch of warm-up, then lockstep passes by tile error
    spp_a = CAMERA_WARMUP_SPP + CAMERA_ADAPTIVE_PASSES
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    bufs = render_buffers(scene, spp=spp_a, adaptive=True, passes_per_batch=CAMERA_WARMUP_SPP)
    dt = time.time() - t0
    c = launches["thinlens adaptive"] = counts()
    k3_only("camera-synth thinlens adaptive", c)
    img = bufs.color()
    check(bufs.count.min() >= CAMERA_WARMUP_SPP and bufs.count.max() > bufs.count.min()
          and bufs.count.sum() == spp_a * w * h and bufs.passes == 1 + CAMERA_ADAPTIVE_PASSES
          and np.isfinite(img).all(), f"adaptive: {CAMERA_WARMUP_SPP} warm-up + "
          f"{CAMERA_ADAPTIVE_PASSES} adaptive passes, counts {int(bufs.count.min())}-"
          f"{int(bufs.count.max())}, the whole budget spent, image finite; "
          f"{w * h * spp_a / dt / 1e6:.4f} Mpaths/s ({dt:.2f} s) on {card}")

    for variant in ("equirectangular", "cubemap"):
        sc = flatten_scene(load_scene(paths[variant]), dev)
        m = sc.meta
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        img = render_buffers(sc, spp=CAMERA_OTHER_SPP, seed=DEFAULT_SEED,
                             wavefront="regen").color()
        dt = time.time() - t0
        c = launches[f"{variant} (regen)"] = counts()
        k3_only(f"camera-synth {variant}", c)
        check(img.shape == (m.res_y, m.res_x, 3) and np.isfinite(img).all()
              and (img >= 0).all(), f"camera-synth {variant} ({m.filter}): {img.shape} image "
              f"finite and non-negative")
        log(f"[11 camera] camera-synth {variant}: {m.res_x}x{m.res_y} {CAMERA_OTHER_SPP} spp in "
            f"{dt:.2f} s: {m.res_x * m.res_y * CAMERA_OTHER_SPP / dt / 1e6:.4f} Mpaths/s on "
            f"{card}; channel means {img.reshape(-1, 3).mean(0).round(6).tolist()}")
    log("[11 camera] K3 / K3-fast launches: " + json.dumps(
        {k: [c["bvh8.walk_cuda"], c["bvh8.walk_fast_cuda"]] for k, c in launches.items()}))
    return launches


def interior_phase(work, dev, card):
    """Phase 8: the interior cell's surfaces. Returns the kernel launch
    counts of the two full-width renders, {wavefront: counts()}."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.integrators.path_tracer import count_bsdf_hits
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.models.bsdfs.dispatch import type_name
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    paths = {size: synth.write_scene(os.path.join(work, size), size)
             for size in ("small-interior", "interior-synth")}
    sky = load_image(os.path.join(work, "interior-synth", "sky.hdr"))
    want = synth._sky(*synth.SIZES["interior-synth"][2:4])
    check(sky.shape == want.shape and bool(np.all(np.abs(sky - want) <= want.max(
        axis=-1, keepdims=True) * 2.0**-7)), f"interior: sky.hdr {sky.shape} reads back within "
          f"RGBE's 8-bit mantissa, peak {sky.max():.1f}")
    with numpy_bvh_build():
        for wavefront in ("regen", "lockstep"):
            render_vs_ref("8 interior", paths["small-interior"], "torch_port_interior_ref.json",
                          dev, wavefront)

    t0 = time.time()
    scene = flatten_scene(load_scene(paths["interior-synth"]), dev)
    flatten_s = time.time() - t0
    m = scene.meta
    log(f"[8 interior] interior-synth flattened in {flatten_s:.1f} s: "
        f"{scene.tris.v0.shape[0]} triangles, {m.n_lights} lights {scene.lights.apx_kind}, "
        f"BSDF types {[type_name(t) for t in scene.materials.present]}; "
        f"{m.res_x}x{m.res_y}, {m.spp} spp, max_bounces {m.max_bounces}")
    gbvh_cost("8 interior", scene, flatten_s)
    with count_bsdf_hits(dev) as hits:
        render_flat(scene, spp=1, seed=DEFAULT_SEED, wavefront="regen")
    log(f"[8 interior] BSDF hits of one regen pass (1 spp, {m.res_x * m.res_y} paths): "
        + json.dumps({type_name(t): n for t, n in sorted(hits.items())}))
    check(all(hits.get(t, 0) > 0 for t in INTERIOR_TYPES),
          f"interior: camera paths hit each of {sorted(INTERIOR_TYPES.values())}")

    means, launches = {}, {}
    for wavefront in ("regen", "lockstep"):
        spp = m.spp if wavefront == "regen" else INTERIOR_LOCKSTEP_SPP
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        img = render_flat(scene, spp=spp, seed=DEFAULT_SEED, wavefront=wavefront)
        dt = time.time() - t0
        c = launches[wavefront] = counts()
        k3_only(f"interior {wavefront}", c)
        if wavefront == "lockstep":
            check_lockstep_launches("interior lockstep", c["bvh8.walk_fast_cuda"],
                                    c["bvh8.walk_cuda"], spp, m.max_bounces)
        check(img.shape == (m.res_y, m.res_x, 3) and np.isfinite(img).all()
              and (img >= 0).all(), f"interior {wavefront}: {img.shape} image finite and "
              f"non-negative")
        means[wavefront] = img.reshape(-1, 3).astype(np.float64).mean(0)
        log(f"[8 interior] interior-synth {wavefront}: {m.res_x}x{m.res_y} {spp} spp in "
            f"{dt:.2f} s: {m.res_x * m.res_y * spp / dt / 1e6:.4f} Mpaths/s on {card}; "
            f"channel means {means[wavefront].round(6).tolist()}")
    rel = np.abs(means["lockstep"] - means["regen"]) / np.abs(means["regen"])
    check((rel <= WAVEFRONT_RTOL).all(), f"interior-synth: lockstep channel means vs regen's "
          f"(rel {rel.max():.2e} <= {WAVEFRONT_RTOL})")
    return launches


def surfaces_phase(work, dev, card):
    """Phase 9: the remaining surfaces and the forward-lobe branch. Returns
    ({render: counts()} of the three full-width renders, {window: profile})."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.integrators.path_tracer import count_bsdf_hits
    from tungsten_tpu_torch.models.bsdfs.dispatch import type_name
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    paths = {size: synth.write_scene(os.path.join(work, size), size)
             for size in ("small-coat", "small-cutout", "coat-synth", "cutout-synth")}
    with numpy_bvh_build():
        for wavefront in ("regen", "lockstep"):
            render_vs_ref("9 surfaces", paths["small-coat"], "torch_port_coat_ref.json", dev,
                          wavefront)
        render_vs_ref("9 surfaces", paths["small-cutout"], "torch_port_cutout_ref.json", dev,
                      "lockstep")

    scenes = {}
    for size in ("coat-synth", "cutout-synth"):
        t0 = time.time()
        sc = scenes[size] = flatten_scene(load_scene(paths[size]), dev)
        m = sc.meta
        log(f"[9 surfaces] {size} flattened in {time.time() - t0:.1f} s: "
            f"{sc.tris.v0.shape[0]} triangles, {m.n_lights} lights {sc.lights.apx_kind}, "
            f"BSDF types {[type_name(t) for t in sc.materials.present]}, forward lobes "
            f"{m.has_forward}, gpack3 {sc.materials.gpack3 is not None}; "
            f"{m.res_x}x{m.res_y}, {m.spp} spp, max_bounces {m.max_bounces}")
    coat, cutout = scenes["coat-synth"], scenes["cutout-synth"]
    coat_short, short = (dataclasses.replace(sc, meta=dataclasses.replace(
        sc.meta, max_bounces=PROFILE_BOUNCES)) for sc in (coat, cutout))
    hits = {}

    def check_hits(label, size, h):
        log(f"[9 surfaces] BSDF hits of {label}: "
            + json.dumps({type_name(t): n for t, n in sorted(h.items())}))
        check(all(h.get(t, 0) > 0 for t in SURFACE_TYPES[size]),
              f"{label}: camera paths hit each of {sorted(SURFACE_TYPES[size].values())}")

    def coat_pass():  # one regen pass, 1 spp; its first (bare) run counts the hits
        with count_bsdf_hits(dev) as h:
            render_flat(coat_short, spp=1, seed=DEFAULT_SEED, wavefront="regen")
        hits.setdefault("coat", h)

    profiles = {
        f"coat-synth regen batch (1 pass, {PROFILE_BOUNCES} bounces)": profile_window(
            f"coat-synth, one regen batch of 1 pass of {PROFILE_BOUNCES} bounces", coat_pass,
            card),
        f"cutout-synth lockstep ({PROFILE_BOUNCES} bounces)": profile_window(
            f"cutout-synth, one lockstep pass of {PROFILE_BOUNCES} bounces",
            lambda: render_flat(short, spp=1, seed=DEFAULT_SEED, wavefront="lockstep"), card),
    }
    check_hits(f"one regen pass of coat-synth (1 spp, {PROFILE_BOUNCES} bounces)", "coat-synth",
               hits["coat"])

    means, launches = {}, {}
    for size, wavefront in (("coat-synth", "regen"), ("coat-synth", "lockstep"),
                            ("cutout-synth", "lockstep")):
        sc = scenes[size]
        m = sc.meta
        spp = m.spp if wavefront == "regen" else SURFACE_LOCKSTEP_SPP[size]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with tracer_calls() as calls, count_bsdf_hits(dev) as h:
            img = render_flat(sc, spp=spp, seed=DEFAULT_SEED, wavefront=wavefront)
        dt = time.time() - t0
        label = f"{size} {wavefront}"
        check_hits(f"the {label} render ({spp} spp)", size, h)
        c = launches[label] = counts()
        k3_only(label, c)
        if m.has_forward:
            check_forward_launches(label, c["bvh8.walk_fast_cuda"], c["bvh8.walk_cuda"], calls,
                                   spp, m.max_bounces)
        elif wavefront == "lockstep":
            check_lockstep_launches(label, c["bvh8.walk_fast_cuda"], c["bvh8.walk_cuda"], spp,
                                    m.max_bounces)
        check(img.shape == (m.res_y, m.res_x, 3) and np.isfinite(img).all()
              and (img >= 0).all(), f"{label}: {img.shape} image finite and non-negative")
        means[label] = img.reshape(-1, 3).astype(np.float64).mean(0)
        log(f"[9 surfaces] {label}: {m.res_x}x{m.res_y} {spp} spp in {dt:.2f} s: "
            f"{m.res_x * m.res_y * spp / dt / 1e6:.4f} Mpaths/s on {card}; "
            f"{calls['shading']} iterations ({dt / max(calls['shading'], 1) * 1e3:.1f} ms each); "
            f"channel means {means[label].round(6).tolist()}")
    rel = (np.abs(means["coat-synth lockstep"] - means["coat-synth regen"])
           / np.abs(means["coat-synth regen"]))
    check((rel <= WAVEFRONT_RTOL).all(), f"coat-synth: lockstep channel means vs regen's "
          f"(rel {rel.max():.2e} <= {WAVEFRONT_RTOL})")
    return launches, profiles


# phase 12: the media-synth renders' spp (regen keeps the scene's 32)
MEDIA_LOCKSTEP_SPP = 1  # fog and cloud through lockstep
MEDIA_FORWARD_SPP = 1  # forward through the crossing-walk branch
MEDIA_RENDERS = (("fog", "regen"), ("cloud", "regen"), ("haze", "regen"), ("fog", "lockstep"),
                 ("cloud", "lockstep"), ("forward", "lockstep"))
K6_RAYS = 65536
# K6's f32 operations, counted from csrc/grid_walk.cu's body on the linear
# (trilinear) path, an add, sub, mul, divide, floor / ceil, min, max or
# comparison counting one: a lane's set-up (per axis |dq|, its test, the
# reciprocal) 9; a round's boundary step (per axis the point 3, the sign
# test 1, floor / ceil and its step 2, the axis's t 3; two mins, the
# minimum progress 2, the clip 1, the live and done tests 2) 34, its
# segment_tau 106 (the width 1; per Gauss node its t 2, the point 6, the
# trilinear sample 43: the cell offset 3, floor 3, fractions 3, their
# complements 3, eight corners' weight, product and sum 31; then the sum,
# the half width and the product 3) and the fold 1; an inverse round's
# crossing test 1 more; a bisection round the midpoint 2, segment_tau 106,
# the sum and its test 2, and each found lane's last midpoint 2
K6_OPS_LANE, K6_OPS_ROUND, K6_OPS_BISECT, K6_OPS_FOUND = 9, 141, 110, 2


def k6_bound(work, n, walking, inverse, grid_bytes, masked):
    """(bound_ms, bound_by, bytes, ops) of one K6 launch over n lanes, of
    which `walking` walk, whose twin counted `work`. Bytes: what the launch
    must move at least, the grid once (its cells are read from L2 after
    their first touch), the walking lanes' rays, spans (and targets) once,
    the mask (when given) and the output of every lane; over the memory
    rate. Operations: K6_OPS_* on the twin's lane-rounds, over the f32
    rate."""
    from tungsten_tpu_torch.ops.grid_walk import BISECT_ROUNDS

    n_bytes = (grid_bytes + walking * 4 * (3 + 3 + 1 + 1 + (1 if inverse else 0))
               + n * (4 + (1 if masked else 0)))
    found = work["bisect"] // BISECT_ROUNDS
    ops = (walking * K6_OPS_LANE + work["rounds"] * (K6_OPS_ROUND + (1 if inverse else 0))
           + work["bisect"] * K6_OPS_BISECT + found * K6_OPS_FOUND)
    return (*bound(n_bytes, ops), n_bytes, ops)


def k6_check(label, density, linear, args, card):
    """K6 against its twin on one launch's inputs (oq, dq, ta, tb, mode,
    target, mask): bit for bit, or within rtol 1e-6 on >= 99.9% of the
    finite lanes with the INF lanes equal; the kernel's ms (median of 5
    single-launch windows), the twin's ms (one run, host clock around it and
    a synchronise), the twin's rounds and the bound. Returns a dict."""
    from tungsten_tpu_torch.ops import grid_walk

    oq, dq, ta, tb, mode, target, mask = args
    out = grid_walk.walk_cuda(density, linear, oq, dq, ta, tb, mode, target, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = grid_walk.walk_twin(density, linear, oq, dq, ta, tb, mode, target, mask)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    work = dict(grid_walk.walk_twin.work)
    fin = (out < 1e30) & (twin < 1e30)
    err = float((out[fin] - twin[fin]).abs().max()) if bool(fin.any()) else 0.0
    bits = bool(torch.equal(out, twin))
    close = (torch.isclose(out[fin], twin[fin], rtol=1e-6, atol=0.0).float().mean().item()
             if bool(fin.any()) else 1.0)
    walking = int(mask.sum()) if mask is not None else oq.shape[0]
    check(bits or (bool(torch.equal(out >= 1e30, twin >= 1e30)) and close >= BAR),
          f"K6 {label} ({mode}, {oq.shape[0]} lanes, {walking} walking, {work['rounds']} "
          f"rounds, {work['bisect']} bisection rounds): kernel == twin bit for bit: {bits}; "
          f"within rtol 1e-6 on {close:.6f}, INF lanes equal, max |diff| {err:.3e}")
    ms = median_ms(lambda: grid_walk.walk_cuda(density, linear, oq, dq, ta, tb, mode, target,
                                               mask))
    b_ms, b_by, n_bytes, ops = k6_bound(work, oq.shape[0], walking, mode == "inverse",
                                        nbytes(density), mask is not None)
    log(f"  K6 {label} {mode} on {card}: kernel {ms:.4f} ms, twin {twin_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes} bytes, {ops} f32 operations)")
    return dict(ms=ms, plain_ms=twin_ms, err=err, work=work, bound_ms=b_ms, bound_by=b_by,
                bytes=n_bytes, ops=ops, n=oq.shape[0], walking=walking, mode=mode)


@contextlib.contextmanager
def k6_recorder():
    """While open, every K6 walk (grid_walk.walk, which launches the kernel
    on CUDA rays and counts the launch there) is timed with CUDA events,
    and the inputs of the walk with the most walking lanes of each mode are
    kept: yields {"events": [(start, end)], "largest": {mode: (walking,
    args)}}."""
    from tungsten_tpu_torch.ops import grid_walk

    saved = grid_walk.walk
    rec = {"events": [], "largest": {}}

    def recording(density, linear, oq, dq, ta, tb, mode="tau", tau_target=None, mask=None):
        walking = int(mask.sum()) if mask is not None else oq.shape[0]
        if walking > rec["largest"].get(mode, (0,))[0]:
            keep = [None if x is None else x.clone() for x in (oq, dq, ta, tb, tau_target, mask)]
            rec["largest"][mode] = (walking, (*keep[:4], mode, *keep[4:]))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = saved(density, linear, oq, dq, ta, tb, mode, tau_target, mask)
        end.record()
        rec["events"].append((start, end))
        return out

    grid_walk.walk = recording
    try:
        yield rec
    finally:
        grid_walk.walk = saved


def media_phase(work, dev, card):
    """Phase 12: participating media. small-media's four variants in the
    wavefronts the JAX package runs them in against
    tests/data/torch_port_media_ref.json (numpy BVH build); media-synth
    written (the cloud a 192^3 zip-compressed .vdb) and flattened, the cloud
    read back bit for bit; K6 against its twin on 65,536 random rays through
    the cloud and on the largest launch of each mode of a 1-spp regen pass
    of the cloud (which also gives K6's share of that pass's wall); then
    media-synth at 1000x563: fog, cloud and haze through regen (32 spp),
    fog and cloud through lockstep (MEDIA_LOCKSTEP_SPP), forward through the
    crossing-walk branch (MEDIA_FORWARD_SPP), each counting its launches.
    Returns (K6's kernels-line fields, {render: counts()})."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.models.grids import grid as tg
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    def walks_only(label, c, cloud):
        k6 = c["grid_walk.walk_cuda"]
        others = {k: v for k, v in c.items() if v and k not in (
            "bvh8.walk_cuda", "bvh8.walk_fast_cuda", "grid_walk.walk_cuda")}
        check(c["bvh8.walk_cuda"] > 0 and c["bvh8.walk_fast_cuda"] > 0 and (k6 > 0) == cloud
              and not others, f"{label}: K3 launched {c['bvh8.walk_cuda']} times, K3-fast "
              f"{c['bvh8.walk_fast_cuda']}, K6 {k6}; every other walk, twin and v1 kernel none "
              f"{others}")

    with open(os.path.join(REPO, "tests", "data", "torch_port_media_ref.json")) as f:
        ref = json.load(f)
    with numpy_bvh_build():
        for variant, by_wavefront in ref["channel_means"].items():
            path = synth.write_scene(os.path.join(work, f"small-media-{variant}"), "small-media",
                                     variant)
            sc = flatten_scene(load_scene(path), dev)
            for wavefront, want in by_wavefront.items():
                name = f"small-media {variant} ({wavefront})"
                reset_counts()
                img = render_flat(sc, seed=ref["seed"], wavefront=wavefront)
                walks_only(name, counts(), variant == "cloud")
                check(np.isfinite(img).all() and (img >= 0).all(),
                      f"{name}: image finite and non-negative")
                means = img.reshape(-1, 3).astype(np.float64).mean(0)
                rel = np.abs(means - want) / np.abs(want)
                check((rel <= MEAN_RTOL).all(), f"{name}: channel means "
                      f"{means.round(6).tolist()} vs JAX {np.round(want, 6).tolist()} "
                      f"(rel {rel.max():.2e} <= {MEAN_RTOL})")

    t0 = time.time()
    paths = {v: synth.write_scene(os.path.join(work, f"media-synth-{v}"), "media-synth", v)
             for v in synth.MEDIA_VARIANTS}
    vdb = os.path.join(os.path.dirname(paths["cloud"]), "cloud.vdb")
    log(f"[12 media] media-synth written in {time.time() - t0:.1f} s (cloud.vdb "
        f"{os.path.getsize(vdb) / 2**20:.1f} MiB, zip)")
    scenes = {}
    for v, path in paths.items():
        t0 = time.time()
        scenes[v] = sc = flatten_scene(load_scene(path), dev)
        m = sc.meta
        log(f"[12 media] media-synth {v} flattened in {time.time() - t0:.1f} s: "
            f"{sc.tris.v0.shape[0]} triangles, {sc.media.n_media} media (kinds "
            f"{sc.media.hetero_kind.tolist()}, transmittances {sc.media.trans_present}), camera "
            f"medium {m.camera_medium}, forward lobes {m.has_forward}; {m.res_x}x{m.res_y}, "
            f"{m.spp} spp, max_bounces {m.max_bounces}")
    g = scenes["cloud"].media.vox_grids[0]
    res = synth.CLOUD_RES["media-synth"]
    want = torch.from_numpy(synth.cloud_density(res))
    check(g.dims == (res,) * 3 and g.exact and g.linear and torch.equal(g.density.cpu(), want),
          f"cloud: the {res}^3 grid read back from cloud.vdb bit for bit, exact_linear, "
          f"{g.density.numel() * 4 / 2**20:.1f} MiB on the card")

    # K6 on random rays through the cloud's box, both modes
    gen = np.random.default_rng(12)
    box = synth.CLOUD_BOX
    lo = np.array(box["position"]) - np.array([0.5, 0.0, 0.5]) * box["scale"]
    hi = lo + box["scale"]
    o = torch.tensor(gen.uniform(lo - 0.5, hi + 0.5, (K6_RAYS, 3)), dtype=torch.float32,
                     device=dev)
    aim = torch.tensor(gen.uniform(lo + 0.2, hi - 0.2, (K6_RAYS, 3)), dtype=torch.float32,
                       device=dev)
    d = (aim - o) / (aim - o).norm(dim=1, keepdim=True)
    zero = torch.zeros(K6_RAYS, device=dev)
    oq, dq, ta, tb = tg._walk_inputs(g, o, d, zero, torch.full((K6_RAYS,), 4.0, device=dev))
    k6 = {"random_tau": k6_check("random rays", g.density, True,
                                 (oq, dq, ta, tb, "tau", None, None), card)}
    tau = tg.grid_optical_depth(g, o, d, zero, torch.full((K6_RAYS,), 4.0, device=dev))
    target = (tau * torch.tensor(gen.uniform(0.1, 1.3, K6_RAYS), dtype=torch.float32,
                                 device=dev)).contiguous()
    k6["random_inverse"] = k6_check("random rays", g.density, True,
                                    (oq, dq, ta, tb, "inverse", target, None), card)

    # the cloud render's own lanes: one regen pass, every K6 launch timed
    cloud = scenes["cloud"]
    m = cloud.meta
    torch.cuda.synchronize()
    t0 = time.time()
    with k6_recorder() as rec:
        render_flat(cloud, spp=1, seed=DEFAULT_SEED, wavefront="regen")
        torch.cuda.synchronize()
    wall = time.time() - t0
    k6_ms = sum(a.elapsed_time(b) for a, b in rec["events"])
    log(f"[12 media] cloud, one regen pass (1 spp) on {card}: {len(rec['events'])} K6 launches, "
        f"{k6_ms:.1f} ms of device time in a wall of {wall * 1e3:.1f} ms "
        f"({k6_ms / wall / 10:.2f}%)")
    k6["pass"] = dict(launches=len(rec["events"]), k6_ms=k6_ms, wall_ms=wall * 1e3)
    for mode, (walking, args) in sorted(rec["largest"].items()):
        k6[f"render_{mode}"] = k6_check(f"cloud render lanes ({walking} of {args[0].shape[0]})",
                                        g.density, True, args, card)

    launches, means = {}, {}
    for variant, wavefront in MEDIA_RENDERS:
        sc = scenes[variant]
        m = sc.meta
        spp = (m.spp if wavefront == "regen" else
               MEDIA_FORWARD_SPP if m.has_forward else MEDIA_LOCKSTEP_SPP)
        label = f"media-synth {variant} {wavefront}"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with tracer_calls() as calls:
            img = render_flat(sc, spp=spp, seed=DEFAULT_SEED, wavefront=wavefront)
        dt = time.time() - t0
        c = launches[label] = counts()
        walks_only(label, c, variant == "cloud")
        if m.has_forward:
            check_forward_launches(label, c["bvh8.walk_fast_cuda"], c["bvh8.walk_cuda"], calls,
                                   spp, m.max_bounces, walks_per_bounce=2)
        elif wavefront == "lockstep":
            check_lockstep_launches(label, c["bvh8.walk_fast_cuda"], c["bvh8.walk_cuda"], spp,
                                    m.max_bounces)
        check(img.shape == (m.res_y, m.res_x, 3) and np.isfinite(img).all()
              and (img >= 0).all(), f"{label}: {img.shape} image finite and non-negative")
        means[label] = img.reshape(-1, 3).astype(np.float64).mean(0)
        log(f"[12 media] {label}: {m.res_x}x{m.res_y} {spp} spp in {dt:.2f} s: "
            f"{m.res_x * m.res_y * spp / dt / 1e6:.4f} Mpaths/s on {card}; "
            f"{calls['shading']} iterations ({'bounces' if wavefront == 'lockstep' else 'regen'}), "
            f"K6 {c['grid_walk.walk_cuda']} launches, K3 {c['bvh8.walk_cuda']}, K3-fast "
            f"{c['bvh8.walk_fast_cuda']}; channel means {means[label].round(6).tolist()}")
    for variant in ("fog", "cloud"):
        a, b = means[f"media-synth {variant} lockstep"], means[f"media-synth {variant} regen"]
        log(f"[12 media] media-synth {variant}: lockstep's channel means vs regen's, rel "
            f"{(np.abs(a - b) / np.abs(b)).max():.3e} ({MEDIA_LOCKSTEP_SPP} against {m.spp} spp)")
    k6["launches"] = launches["media-synth cloud regen"]["grid_walk.walk_cuda"]
    return k6, launches


# phase 13's full-width renders of box-synth through the CLI: the light
# tracer's and BDPT's spp (the path tracer, their reference, takes the
# scene's 32), and the JAX tests' bars between them (tests/test_path_tracer.py:
# 145-171): the pixels the path tracer shows between 0.01 and 0.5 (no
# emitter, no filter edge of one), LT's means within 6% of PT's, BDPT's
# median per-pixel ratio within 0.03 of 1 and its means within 5%
BOX_LT_SPP, BOX_BDPT_SPP = 4, 2
LT_PT_RTOL, BDPT_MEDIAN_ATOL, BDPT_PT_RTOL = 0.06, 0.03, 0.05


def bdpt_phase(work, dev, card):
    """Phase 13: the light tracer and BDPT. small-box's LT, BDPT and BDPT
    pyramid renders and small-media fog's LT and BDPT against
    tests/data/torch_port_bdpt_ref.json (numpy BVH build), the pyramid
    summing to its render; small-box's LT twice at one seed, bit for bit;
    box-synth at 1000x563 through the CLI (in process): light_tracer
    (BOX_LT_SPP), bidirectional_path_tracer (BOX_BDPT_SPP) and path_tracer
    (regen, the scene's 32 spp), each counting its launches, held to one
    another by the JAX tests' bars; then one profile window of a single
    BDPT pass of box-synth. Returns {render: counts()} of the box-synth
    renders."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.integrators.bdpt import BDPT_PASS_SEED, trace_bdpt_pass
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.renderer.render import (DEFAULT_SEED, _bdpt_lanes, render_bdpt,
                                                    render_bdpt_pyramid, render_light_traced)
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene
    from tungsten_tpu_torch.tools import tungsten as cli

    with open(os.path.join(REPO, "tests", "data", "torch_port_bdpt_ref.json")) as f:
        ref = json.load(f)
    seed = ref["seed"]
    with numpy_bvh_build():
        small = {"small-box": flatten_scene(load_scene(synth.write_scene(
                     os.path.join(work, "small-box-bdpt"), "small-box")), dev),
                 "small-media-fog": flatten_scene(load_scene(synth.write_scene(
                     os.path.join(work, "small-media-fog-bdpt"), "small-media", "fog")), dev)}
    lt_first = None
    for key, sc in small.items():
        for name, want in ref["channel_means"][key].items():
            label = f"{key} {name}"
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.time()
            if name == "lt":
                img = render_light_traced(sc, seed=seed)
            elif name == "bdpt":
                img = render_bdpt(sc, seed=seed)
            else:
                img, stack = render_bdpt_pyramid(sc, spp=ref["pyramid_spp"], seed=seed)
                err = float(np.abs(sum(stack.values()) - img).max())
                check(len(stack) == 26 and err <= 1e-5, f"{label}: {len(stack)} (s, t) images "
                      f"summing to the render (largest difference {err:.2e} <= 1e-5)")
            dt = time.time() - t0
            k3_only(label, counts())
            check(np.isfinite(img).all() and (img >= 0).all(), f"{label}: image finite and "
                  f"non-negative")
            means = img.reshape(-1, 3).astype(np.float64).mean(0)
            rel = np.abs(means - want) / np.abs(want)
            check((rel <= MEAN_RTOL).all(), f"{label}: channel means {means.round(6).tolist()} "
                  f"vs JAX {np.round(want, 6).tolist()} (rel {rel.max():.2e} <= {MEAN_RTOL}) "
                  f"in {dt:.2f} s on {card}")
            if key == "small-box" and name == "lt":
                lt_first = img
    again = render_light_traced(small["small-box"], seed=seed)
    check(np.array_equal(again, lt_first), "small-box lt: rendered twice at one seed, bit for "
          "bit equal")

    launches, imgs = {}, {}
    runs = (("light_tracer", BOX_LT_SPP, "render_light_traced"),
            ("bidirectional_path_tracer", BOX_BDPT_SPP, "render_bdpt"),
            ("path_tracer", None, "render_buffers"))
    for variant, spp, fn in runs:
        path = synth.write_scene(os.path.join(work, f"box-synth-{variant}"), "box-synth", variant)
        out = os.path.dirname(path)
        argv = [path, "-q", "-o", "box.png", "-e", "box.pfm"] + (["-s", str(spp)] if spp else [])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with timed_renders(fn) as timed:
            cli.main(argv)
        wall = time.time() - t0
        c = launches[variant] = counts()
        k3_only(f"box-synth {variant}", c)
        img = imgs[variant] = load_image(os.path.join(out, "box.pfm"))
        h, w = img.shape[:2]
        spp = spp or synth.SIZES["box-synth"][5]
        check((w, h) == synth.SIZES["box-synth"][4] and np.isfinite(img).all() and (img >= 0).all()
              and os.path.exists(os.path.join(out, "box.png")),
              f"box-synth {variant}: the CLI wrote box.png and a {w}x{h} box.pfm, finite and "
              f"non-negative")
        dt = timed[0][0]
        log(f"[13 bdpt] box-synth {variant} through the CLI: {w}x{h} {spp} spp, render "
            f"{dt:.2f} s ({w * h * spp / dt / 1e6:.4f} Mpaths/s), CLI call {wall:.2f} s on "
            f"{card}; K3 {c['bvh8.walk_cuda']} launches, K3-fast {c['bvh8.walk_fast_cuda']}; "
            f"channel means {img.reshape(-1, 3).astype(np.float64).mean(0).round(6).tolist()}")
    pt = imgs["path_tracer"].astype(np.float64)
    mask = (pt.max(-1) < 0.5) & (pt.max(-1) > 0.01)
    m_pt = pt[mask].mean(0)
    m_lt = imgs["light_tracer"][mask].astype(np.float64).mean(0)
    bd = imgs["bidirectional_path_tracer"][mask].astype(np.float64)
    rel_lt = np.abs(m_lt - m_pt) / m_pt
    check((rel_lt <= LT_PT_RTOL).all(), f"box-synth: on {mask.sum()} pixels ({mask.mean():.4f}) "
          f"LT's means {m_lt.round(6).tolist()} vs PT's {m_pt.round(6).tolist()} (rel "
          f"{rel_lt.max():.3e} <= {LT_PT_RTOL})")
    med = np.median(bd / np.maximum(pt[mask], 1e-9), axis=0)
    rel_bd = np.abs(bd.mean(0) - m_pt) / m_pt
    check((np.abs(med - 1.0) <= BDPT_MEDIAN_ATOL).all() and (rel_bd <= BDPT_PT_RTOL).all(),
          f"box-synth: BDPT's median per-pixel ratio to PT {med.round(4).tolist()} (within "
          f"{BDPT_MEDIAN_ATOL} of 1), its means {bd.mean(0).round(6).tolist()} (rel "
          f"{rel_bd.max():.3e} <= {BDPT_PT_RTOL})")

    scene = flatten_scene(load_scene(os.path.join(work, "box-synth-bidirectional_path_tracer",
                                                  "scene.json")), dev)
    lanes = _bdpt_lanes(scene.meta, dev)
    prof = profile_window("box-synth: one BDPT pass (1000x563, K = "
                          f"{min(scene.meta.max_bounces + 1, scene.meta.bdpt_max_vertices)})",
                          lambda: trace_bdpt_pass(scene, (DEFAULT_SEED, BDPT_PASS_SEED), *lanes),
                          card, tag="13 profile", iterations=1)
    log(f"[13 bdpt] one BDPT pass of box-synth on {card}: {prof['kernels']} CUDA kernels, "
        f"device busy {prof['busy_share_of_bare_wall']:.4f} of the bare wall "
        f"{prof['bare_wall_s']:.3f} s")
    return launches, imgs["path_tracer"]


# phase 14: SPPM. The full-width renders' iterations (2^18 photons each,
# the scene's photon_count), and their bars: photon_map and
# progressive_photon_map against the path tracer's image (phase 13's
# box-synth PT, 32 spp) by the JAX test's median per-pixel ratio on the
# pixels PT shows between 0.02 and 0.5 (tests/test_path_tracer.py:173-194).
# The fog's beams, planes and planes_1d by their median ratio to points on
# the pixels points shows above 0.01: the JAX tests' bar (0.2 of 1,
# tests/test_path_tracer.py:197-288) is one the JAX package itself misses
# at 2^18 photons (its ratios on small-box fog there are 0.65-0.85, ROADMAP
# §3), so the port is held to the JAX package's ratio: on small-box at that
# count within SPPM_FOG_RATIO_RTOL (the same scene, photons and iterations
# on both sides), and at full width within SPPM_FOG_FULL_RTOL. box-synth
# differs from small-box in its resolution (1000x563, 32x24) and iterations
# (SPPM_FOG_ITERS, the reference's 2), and on an H100 its ratios stood
# 0.5-6.1% from the JAX package's at one or two plane iterations
# (planes_1d at one the farthest, 2.9-3.3% at two); a missing or doubled
# share of the pairs would move them by tens of per cent.
SPPM_ITERS = 8  # box-synth photon_map, progressive_photon_map, caustic
SPPM_FOG_ITERS = 4  # box-synth fog, all four volume photon types
SPPM_PT_MEDIAN_ATOL, SPPM_FOG_RATIO_RTOL, SPPM_FOG_FULL_RTOL = 0.12, 0.02, 0.1
# K7's operations, tallied from csrc/photon_walk.cu (an add, sub, mul,
# divide, sqrt, abs, min, max, float-int conversion or comparison counts
# one, integer ones too; the tally is in the kernel's header comment):
# accept() a candidate row, the bin of an accepted hist row, visit() a
# lane-round (27 neighbour hashes) and dda_step() a volume round
K7_OPS = {"surface": 14, "hist": 14, "points": 39, "beams": 88}
K7_BIN_OPS = 4
K7_VISIT_OPS, K7_STEP_OPS = 27 * 10, 4
# K7's bytes: the fields of a candidate row that accept() loads (p and the
# bounce; beams also d, len and s0), a pair written (lane and row, with
# two floats in the volume modes), and a walking lane's inputs (o, lim and
# bounce, d in the volume modes); every lane reads its mask byte
K7_ROW_BYTES = {"surface": 16, "hist": 16, "points": 16, "beams": 36}
K7_PAIR_BYTES = {"surface": 8, "hist": 0, "points": 16, "beams": 16}
K7_LANE_BYTES = {"surface": 20, "hist": 20, "points": 32, "beams": 32}


@contextlib.contextmanager
def k7_recorder():
    """While open, every K7 walk (photon_walk.walk) is counted: yields
    {"calls": {mode: n}, "pairs": {mode: n}, "first": {mode: args}}, the
    arguments of each mode's first call kept (a render's first camera
    bounce: its widest)."""
    from tungsten_tpu_torch.ops import photon_walk

    saved = photon_walk.walk
    rec = {"calls": {}, "pairs": {}, "first": {}}

    def recording(mode, *args):
        out = saved(mode, *args)
        rec["first"].setdefault(mode, args)
        rec["calls"][mode] = rec["calls"].get(mode, 0) + 1
        rec["pairs"][mode] = rec["pairs"].get(mode, 0) + (0 if mode == "hist" else
                                                          int(out[0].shape[0]))
        return out

    photon_walk.walk = recording
    try:
        yield rec
    finally:
        photon_walk.walk = saved


def k7_bound(mode, args, work, binned=0):
    """K7's bound on a call (args as photon_walk.walk's) from the twin's
    work on it: (bytes, operations). The rows: those the hash cells can
    give (sum of min(count, 32)), at most one a candidate test; the cell
    tables' entries a lane-round reads, at most the tables; the pairs or
    the histogram written; the lanes' inputs. binned: the hist mode's
    accepted rows (the histogram's sum)."""
    from tungsten_tpu_torch.ops.photon_walk import MAX_PER_CELL

    n = args[3].shape[0]
    visits = work["lanes"] * max(work["rounds"], 1)
    rows = min(work["tests"], int(torch.clamp(args[2], max=MAX_PER_CELL).sum()))
    n_bytes = (rows * K7_ROW_BYTES[mode] + min(visits * 27 * 8, nbytes(args[1], args[2]))
               + work["pairs"] * K7_PAIR_BYTES[mode] + n + work["lanes"] * K7_LANE_BYTES[mode]
               + (n * 128 if mode == "hist" else 0))
    ops = (work["tests"] * K7_OPS[mode] + binned * K7_BIN_OPS + visits * K7_VISIT_OPS
           + (work["lanes"] * work["rounds"] * K7_STEP_OPS))
    return n_bytes, ops


def k7_check(label, mode, args, card):
    """K7 against its twin on a recorded call, bit for bit (pairs, floats
    or histogram); the kernel's ms (median of 5 event windows), the twin's
    (one call), the twin's work and the bound (k7_bound)."""
    from tungsten_tpu_torch.ops import photon_walk

    out = photon_walk.walk_cuda(mode, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = photon_walk.walk_twin(mode, *args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3  # one call, host clock: the twin is slow
    work = dict(photon_walk.walk_twin.work)
    binned = int(twin.sum()) if mode == "hist" else 0
    if mode == "hist":
        out, twin = (out,), (twin,)
    err = max([float((a - b).abs().max()) for a, b in zip(out, twin)
               if a.is_floating_point() and a.numel()] + [0.0])
    check(same_bits(out, twin), f"K7 {mode} ({label}): kernel and twin equal bit for bit, "
          f"{work['pairs']} pairs of {work['tests']} candidate rows, {work['lanes']} lanes, "
          f"{work['rounds']} rounds")
    ms = median_ms(lambda: photon_walk.walk_cuda(mode, *args))
    n_bytes, ops = k7_bound(mode, args, work, binned)
    b_ms, b_by = bound(n_bytes, ops)
    log(f"[14 k7] {mode} ({label}) on {card}: {work['pairs']} pairs, kernel {ms:.4f} ms "
        f"(median of 5), twin {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{n_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} G f32 ops): the kernel at {b_ms / ms:.4f} "
        f"of its bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "ops": ops, "err": err, "work": work}


def sppm_only(label, c):
    """K3, K3-fast and K7 launched, no twin and no v1 kernel, in counts c."""
    twins = {k: v for k, v in c.items() if "twin" in k and v}
    check(c["bvh8.walk_cuda"] > 0 and c["bvh8.walk_fast_cuda"] > 0
          and c["photon_walk.walk_cuda"] > 0 and not twins and v1_launches(c) == 0,
          f"{label}: K3 launched {c['bvh8.walk_cuda']} times, K3-fast "
          f"{c['bvh8.walk_fast_cuda']}, K7 {c['photon_walk.walk_cuda']}, no twin {twins} and "
          f"no v1 kernel")


def sppm_phase(work, dev, card, pt_img):
    """Phase 14: SPPM. box-synth at 1000x563 through the CLI (in process),
    2^18 photons an iteration: photon_map (kNN, 20) and
    progressive_photon_map (SPPM_ITERS) held to phase 13's path-traced image
    `pt_img` by the JAX test's median ratio, the caustic variant (a glass
    ball) at SPPM_ITERS finite and non-negative with its overflow, and the
    fog's four volume photon types (SPPM_FOG_ITERS) held to points; each
    render's launches reset just before and read just after, its wall,
    pairs an iteration and overflow. Then K7 against its twin bit for bit
    on the first call of each mode in those renders (surface fixed and kNN
    with its histogram on box-synth's gather points, points and beams on
    box-synth fog's first camera segments), timed, with its bound; small-box
    (numpy BVH build) in every reference render of
    tests/data/torch_port_sppm_ref.json against the JAX means and overflow,
    and the fog modes' ratios to points against the JAX package's; one
    profile window of an SPPM iteration of box-synth. Returns (the
    progressive render's counts(), {render: counts()}, {mode: K7 check})."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.io.imageio import load_image
    from tungsten_tpu_torch.renderer import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene
    from tungsten_tpu_torch.tools import tungsten as cli

    launches, imgs, kept = {}, {}, {}
    runs = [("photon_map", "photon_map", SPPM_ITERS, ("hist", "surface")),
            ("progressive_photon_map", "progressive_photon_map", SPPM_ITERS, ("surface",)),
            ("progressive_photon_map+caustic", "caustic", SPPM_ITERS, ()),
            ("progressive_photon_map+fog+points", "fog points", SPPM_FOG_ITERS, ("points",)),
            ("progressive_photon_map+fog+beams", "fog beams", SPPM_FOG_ITERS, ("beams",)),
            ("progressive_photon_map+fog+planes", "fog planes", SPPM_FOG_ITERS, ()),
            ("progressive_photon_map+fog+planes_1d", "fog planes_1d", SPPM_FOG_ITERS, ())]
    for variant, name, iters, keep in runs:
        path = synth.write_scene(os.path.join(work, "box-synth-" + variant.replace("+", "-")),
                                 "box-synth", variant)
        out = os.path.dirname(path)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        with timed_renders("render_sppm") as timed, k7_recorder() as rec:
            cli.main([path, "-q", "-o", "sppm.png", "-e", "sppm.pfm", "-s", str(iters)])
            ovf = render.render_sppm.last_overflow  # the timed wrapper's, set by the render
        wall = time.time() - t0
        c = launches[name] = counts()
        sppm_only(f"box-synth {name}", c)
        for mode in keep:
            kept[f"{mode} ({name})"] = (mode, rec["first"][mode])
        img = imgs[name] = load_image(os.path.join(out, "sppm.pfm"))
        h, w = img.shape[:2]
        check((w, h) == synth.SIZES["box-synth"][4] and np.isfinite(img).all() and (img >= 0).all()
              and os.path.exists(os.path.join(out, "sppm.png")),
              f"box-synth {name}: the CLI wrote sppm.png and a {w}x{h} sppm.pfm, finite and "
              f"non-negative; overflow {ovf}")
        pairs = {m: round(n / iters) for m, n in rec["pairs"].items()}
        log(f"[14 sppm] box-synth {name} through the CLI: {w}x{h}, {iters} iterations of "
            f"{synth.PHOTON_COUNT['box-synth']} photons, render {timed[0][0]:.2f} s, CLI call "
            f"{wall:.2f} s on {card}; K7 {c['photon_walk.walk_cuda']} launches "
            f"({rec['calls']} calls), pairs an iteration {pairs}, overflow {ovf}; K3 "
            f"{c['bvh8.walk_cuda']}, K3-fast {c['bvh8.walk_fast_cuda']}; channel means "
            f"{img.reshape(-1, 3).astype(np.float64).mean(0).round(6).tolist()}")
    pt = pt_img.astype(np.float64)
    mask = (pt.max(-1) < 0.5) & (pt.max(-1) > 0.02)
    for name in ("photon_map", "progressive_photon_map"):
        med = np.median(imgs[name][mask] / np.maximum(pt[mask], 1e-9), axis=0)
        check((np.abs(med - 1.0) <= SPPM_PT_MEDIAN_ATOL).all(),
              f"box-synth {name}: median per-pixel ratio to PT {med.round(4).tolist()} on "
              f"{mask.sum()} pixels (within {SPPM_PT_MEDIAN_ATOL} of 1)")

    with open(os.path.join(REPO, "tests", "data", "torch_port_sppm_ref.json")) as f:
        ref = json.load(f)
    # the JAX package's ratios to points on small-box fog at the full-width
    # renders' photon count (the beams' image depends on it, ROADMAP §3)
    full = ref["fog_median_ratio_at"]
    check(full["photons"] == synth.PHOTON_COUNT["box-synth"], f"the reference's fog ratios at "
          f"{full['photons']} photons, the full-width renders' count")
    points = imgs["fog points"].astype(np.float64)
    fmask = points.max(-1) > 0.01
    for vtype in ("beams", "planes", "planes_1d"):
        med = np.median(imgs[f"fog {vtype}"][fmask] / np.maximum(points[fmask], 1e-9), axis=0)
        jax_med = np.asarray(full[f"fog-{vtype}"])
        rel = np.abs(med - jax_med) / jax_med
        check((rel <= SPPM_FOG_FULL_RTOL).all(),
              f"box-synth fog {vtype}: median ratio to points {med.round(4).tolist()} on "
              f"{fmask.sum()} pixels vs the JAX package's {jax_med.round(4).tolist()} on "
              f"small-box fog at {full['photons']} photons (rel {rel.max():.2e} <= "
              f"{SPPM_FOG_FULL_RTOL})")

    k7 = {label: k7_check(label, mode, args, card) for label, (mode, args) in kept.items()}
    kept.clear()

    seed, spp = ref["seed"], ref["spp"]
    small, small_imgs = {}, {}
    for key, (variant, integ, vtype) in ref["variants"].items():
        base = variant.split("+", 1)[1] if "+" in variant else ""
        if base not in small:
            with numpy_bvh_build():
                path = synth.write_scene(os.path.join(work, "small-box-sppm-" + (base or "box")),
                                         "small-box", variant)
                doc = load_scene(path)
                if base == "fog":
                    doc.camera["resolution"] = list(ref["fog_resolution"])
                small[base] = flatten_scene(doc, dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        img = small_imgs[key] = render.render_sppm(
            small[base], spp=spp, seed=seed, photons_per_iter=ref["photons"][key],
            volume_photon_type=vtype, gather_count=(synth.GATHER_COUNT["small-box"]
                                                    if integ == "photon_map" else None))
        dt = time.time() - t0
        sppm_only(f"small-box {key}", counts())
        ovf, want_ovf = render.render_sppm.last_overflow, ref["overflow"][key]
        want = np.asarray(ref["channel_means"][key])
        means = img.reshape(-1, 3).astype(np.float64).mean(0)
        rel = np.abs(means - want) / np.abs(want)
        check(np.isfinite(img).all() and (img >= 0).all() and (rel <= MEAN_RTOL).all()
              and abs(ovf - want_ovf) <= 1e-3 * want_ovf,
              f"small-box {key}: channel means {means.round(6).tolist()} vs JAX "
              f"{np.round(want, 6).tolist()} (rel {rel.max():.2e} <= {MEAN_RTOL}), overflow "
              f"{ovf} vs JAX {want_ovf} (within 0.1%), in {dt:.2f} s on {card}")
    # small-box fog's ratios to points against the JAX package's, at the
    # references' photon count and at the full-width renders'
    at_full = {v: render.render_sppm(small["fog"], spp=spp, seed=seed,
                                     photons_per_iter=full["photons"], volume_photon_type=v)
               for v in ("points", "beams", "planes", "planes_1d")}
    for photons, imgs_of, want in (
            (ref["photons"]["fog-points"], lambda v: small_imgs[f"fog-{v}"],
             ref["fog_median_ratio"]), (full["photons"], at_full.get, full)):
        pts = imgs_of("points").astype(np.float64)
        smask = pts.max(-1) > 0.01
        for vtype in ("beams", "planes", "planes_1d"):
            med = np.median(imgs_of(vtype)[smask] / np.maximum(pts[smask], 1e-9), axis=0)
            jax_med = np.asarray(want[f"fog-{vtype}"])
            rel = np.abs(med - jax_med) / jax_med
            check((rel <= SPPM_FOG_RATIO_RTOL).all(),
                  f"small-box fog {vtype} at {photons} photons: median ratio to points "
                  f"{med.round(4).tolist()} vs the JAX package's {jax_med.round(4).tolist()} "
                  f"(rel {rel.max():.2e} <= {SPPM_FOG_RATIO_RTOL})")

    scene = flatten_scene(load_scene(os.path.join(
        work, "box-synth-progressive_photon_map", "scene.json")), dev)
    prof = profile_window("box-synth: one SPPM iteration (1000x563, 2^18 photons)",
                          lambda: render.render_sppm(scene, spp=1), card, tag="14 profile",
                          iterations=1)
    log(f"[14 sppm] one SPPM iteration of box-synth on {card}: {prof['kernels']} CUDA kernels, "
        f"device busy {prof['busy_share_of_bare_wall']:.4f} of the bare wall "
        f"{prof['bare_wall_s']:.3f} s")
    return launches["progressive_photon_map"], launches, k7


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a card")
    from tungsten_tpu_torch import device
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.ops import _build, bvh, bvh2, bvh8, intersect_stream
    from tungsten_tpu_torch.ops.intersect import INF, intersect_brute
    from tungsten_tpu_torch.renderer.render import DEFAULT_SEED, render_flat
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene
    from tungsten_tpu_torch.tools import bench_isect

    dev = device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    sources = ("bvh8_walk", "bvh8_walk_fast", "bvh8_walk_v1", "bvh8_walk_fast_v1", "bvh2_walk",
               "bvh2_walk_v1", "bvh_walk", "bvh_walk_v1", "intersect_stream",
               "intersect_stream_v1", "gather_walk", "grid_walk", "photon_walk")
    native = build_native_bvh()
    _build.build(*sources)
    for name in sources:
        _build.load_library(name)
    log(f"[2 build] {', '.join(sources)} built in {time.time() - t0:.2f} s (nvcc, sm_90a, "
        f"in parallel)")
    native()
    for name in ("bvh8_walk", "bvh8_walk_fast", "bvh_walk", "intersect_stream", "gather_walk",
                 "grid_walk", "photon_walk"):
        occ = getattr(_build.load_library(name), f"{name}_blocks_per_sm")
        occ.restype = ctypes.c_int
        log(f"[2 build] {name}: {occ()} resident blocks of 128 threads a multiprocessor; "
            f"ptxas -v:\n{_build.ptxas_report(name)}")
    occ = _build.load_library("bvh2_walk").bvh2_walk_blocks_per_sm
    occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int]
    log(f"[2 build] bvh2_walk: {occ(0)} (ordered) / {occ(1)} (skip) / {occ(2)} (any) resident "
        f"blocks of 128 threads a multiprocessor; ptxas -v:\n{_build.ptxas_report('bvh2_walk')}")

    work = os.path.join(REPO, "build", "chip_smoke")  # scenes are written here
    big_path = synth.write_scene(os.path.join(work, "mt"), "materialtest-synth")
    t0 = time.time()
    scene = flatten_scene(load_scene(big_path), dev)
    flatten_s = time.time() - t0
    n_tris = scene.tris.v0.shape[0]
    log(f"[3 kernel] materialtest-synth flattened in {flatten_s:.1f} s: "
        f"{n_tris} triangles, {scene.pbvh8.kid_t.shape[0]} BVH8 nodes, "
        f"{scene.pbvh8.tri_planes.shape[0]} leaves")
    gbvh_cost("3 kernel", scene, flatten_s)
    pack = scene.pbvh8
    gen = np.random.default_rng(0)
    lo = scene.tris.v0.min(0).values.cpu().numpy() - 0.5
    hi = scene.tris.v0.max(0).values.cpu().numpy() + 0.5
    extent = float(np.abs(np.concatenate([lo, hi])).max())
    T_ATOL = T_ATOL_PER_EXTENT * extent

    def rand_rays(n):
        o = torch.tensor(gen.uniform(lo, hi, (n, 3)), dtype=torch.float32, device=dev)
        d = torch.tensor(gen.normal(size=(n, 3)), dtype=torch.float32, device=dev)
        return (o, d / d.norm(dim=1, keepdim=True), torch.full((n,), 1e-4, device=dev),
                torch.full((n,), INF, device=dev))

    # 65,536 random incoherent rays: closest hit and occlusion
    rays = rand_rays(65536)
    tk, lk = bvh8.walk_cuda(pack, *rays)
    torch.cuda.synchronize()
    tt, lt = bvh8.walk_twin(pack, *rays)
    check(agree(lk, lt) >= BAR, f"random 65536: kernel vs twin prim agree {agree(lk, lt):.6f}")
    same = (lk == lt) & (lk >= 0)
    check(t_close(tk[same], tt[same], T_ATOL),
          f"random 65536: t within rtol {T_RTOL} atol {T_ATOL:.2g} (>= {BAR}), rtol {T_RTOL_ALL} (all)")
    ok_k = bvh8.occluded(pack, *rays)
    ok_t = bvh8.walk_twin(pack, *rays, latch=True)[1] >= 0
    check(agree(ok_k, ok_t) >= BAR, f"random 65536: occlusion agree {agree(ok_k, ok_t):.6f}")

    # brute force on 8,192 rays
    sub = [x[:8192] for x in rays]
    hb = intersect_brute(scene.tris, *sub, chunk=2048)
    hk = bvh8.intersect(pack, scene.tris, *sub, fast=False)
    check(agree(hk.prim, hb.prim) >= BAR, f"8192 rays: kernel vs brute force prim agree "
          f"{agree(hk.prim, hb.prim):.6f}")

    # the slice's 2N mixed batch: 563,000 camera rays (closest) + 563,000
    # latched shadow-like rays from their hit points toward random upper
    # directions (dead where the camera ray missed)
    from tungsten_tpu_torch.models.cameras.pinhole import camera_rays_w

    meta = scene.meta
    n_pix = meta.res_x * meta.res_y
    pix = torch.arange(n_pix, device=dev)
    u = torch.tensor(gen.random((n_pix, 2)), dtype=torch.float32, device=dev)
    oc, dc, _ = camera_rays_w(scene.camera, meta, pix % meta.res_x, pix // meta.res_x, u, u)
    oc = oc.contiguous()
    near = torch.full((n_pix,), 1e-4, device=dev)
    hc = bvh8.intersect(pack, scene.tris, oc, dc, near, torch.full((n_pix,), INF, device=dev),
                        fast=False)
    ps = oc + dc * torch.where(hc.prim >= 0, hc.t, 0.0)[:, None]
    ds = torch.tensor(gen.normal(size=(n_pix, 3)), dtype=torch.float32, device=dev)
    ds[:, 1] = ds[:, 1].abs()
    ds = ds / ds.norm(dim=1, keepdim=True)
    o2 = torch.cat([ps, oc]).contiguous()
    d2 = torch.cat([ds, dc]).contiguous()
    n2 = torch.cat([torch.full((n_pix,), 5e-4, device=dev), near])
    # the shadow lanes' tfar: the distance to a light point on half of them
    # (finite), INF (the sky) on the rest, 0 (dead) where the camera ray missed
    finite = torch.tensor(gen.random(n_pix) < 0.5, device=dev)
    dist = torch.tensor(gen.uniform(0.05, 1.0, n_pix) * extent, dtype=torch.float32, device=dev)
    f2 = torch.cat([torch.where(hc.prim >= 0, torch.where(finite, dist, INF), 0.0),
                    torch.full((n_pix,), INF, device=dev)])
    latch = torch.cat([torch.ones(n_pix, dtype=torch.bool, device=dev),
                       torch.zeros(n_pix, dtype=torch.bool, device=dev)])
    tk, lk = bvh8.walk_cuda(pack, o2, d2, n2, f2, latch)
    torch.cuda.synchronize()
    tt, lt = bvh8.walk_twin(pack, o2, d2, n2, f2, latch)
    k3_work = dict(bvh8.walk_twin.work)
    blocked_agree = agree(lk[:n_pix] >= 0, lt[:n_pix] >= 0)
    prim_agree = agree(lk[n_pix:], lt[n_pix:])
    check(blocked_agree >= BAR, f"2N={2 * n_pix}: shadow occlusion agree {blocked_agree:.6f}")
    check(prim_agree >= BAR, f"2N={2 * n_pix}: camera prim agree {prim_agree:.6f}")
    same = (lk[n_pix:] == lt[n_pix:]) & (lk[n_pix:] >= 0)
    t_err = (tk[n_pix:][same] - tt[n_pix:][same]).abs()
    check(t_close(tk[n_pix:][same], tt[n_pix:][same], T_ATOL),
          f"2N: camera t within rtol {T_RTOL} atol {T_ATOL:.2g} (>= {BAR}), rtol {T_RTOL_ALL} "
          f"(all); max abs err {t_err.max().item():.3e}")
    max_abs_err = t_err.max().item()
    # the warp-cooperative kernel against its one-thread-per-ray form
    cam = (oc, dc, near, torch.full((n_pix,), INF, device=dev))
    r2 = (o2, d2, n2, f2)
    v1_cases = (("random 65536", rays, torch.arange(65536, device=dev) % 2 == 0),
                (f"camera {n_pix}", cam, torch.arange(n_pix, device=dev) % 2 == 0),
                (f"2N={2 * n_pix}", r2, latch))
    for label, rr, lanes in v1_cases:
        for mode, lat in (("closest", None), ("latched", True), ("mixed", lanes)):
            new, old = bvh8.walk_cuda(pack, *rr, lat), bvh8.walk_cuda_v1(pack, *rr, lat)
            torch.cuda.synchronize()
            check(same_bits(new, old), f"{label} {mode}: K3 equals its v1 form bit for bit "
                  f"(slot agree {agree(new[1], old[1]):.6f}, hits {(new[1] >= 0).float().mean().item():.4f})")
    # v1's own error against the twin on the 2N batch (the last case's mixed walk)
    v1_same = (old[1][n_pix:] == lt[n_pix:]) & (lt[n_pix:] >= 0)
    v1_err = (old[0][n_pix:][v1_same] - tt[n_pix:][v1_same]).abs().max().item()
    v1_ms, ms = turns("K3 2N mixed", lambda: bvh8.walk_cuda_v1(pack, o2, d2, n2, f2, latch),
                      lambda: bvh8.walk_cuda(pack, o2, d2, n2, f2, latch), card)
    ms_b2b = cuda_ms(lambda: bvh8.walk_cuda(pack, o2, d2, n2, f2, latch), reps=10)
    v1_ms_b2b = cuda_ms(lambda: bvh8.walk_cuda_v1(pack, o2, d2, n2, f2, latch), reps=10)
    plain_ms = cuda_ms(lambda: bvh8.walk_twin(pack, o2, d2, n2, f2, latch), reps=1)
    log(f"[3 kernel] 2N={2 * n_pix} mixed walk on {card}: CUDA kernel {ms:.3f} ms (v1 "
        f"{v1_ms:.3f}; 10 back to back {ms_b2b:.3f}, v1 {v1_ms_b2b:.3f}), plain PyTorch twin "
        f"{plain_ms:.3f} ms; twin counts {k3_work}")
    k3_bytes = (nbytes(o2, d2, n2, f2, latch, pack.boxes, pack.kid_t, pack.order_t,
                       pack.tri_planes) + 8 * o2.shape[0])

    # K4 and K5 on the same scene: kernel vs twin, public query vs brute force
    log(f"[3b kernels] K4 and K5 on materialtest-synth: {scene.pbvh3.n_nodes} binary nodes, "
        f"{scene.pbvh.tri_t.shape[0]} leaves")
    cases = (("random 65536", rays), (f"camera {n_pix}", cam))
    # the K5 / K2 routes' 2N batch: phase 3's rays and tfar, all closest hit
    with_mixed = cases + ((f"mixed 2N={2 * n_pix}", r2),)
    p3 = scene.pbvh3
    # K4 in its three modes (warp-cooperative leaves): against its twin and
    # its first form by the bars; "ordered" and "skip" against exact K3 (no
    # latch) on the same rays by slot, and t bit for bit where the slots
    # agree; "any" against K3's latch by occlusion
    new_err, k4_work_2n, k4_v1_err = {}, {}, {}  # json name -> error / twin counts at 2N
    for label, rr in with_mixed:
        # the 2N batch's shadow lanes hit at a few tnear: the grazing floor
        grazing = T_ATOL_ALL_GRAZING_PER_EXTENT * extent if rr is r2 else 0.0
        t3, l3 = bvh8.walk_cuda(pack, *rr)
        l3_latch = bvh8.walk_cuda(pack, *rr, latch=True)[1]
        for name, _, mode, _, _ in NEW_KERNELS:
            new = bvh2.walk3_cuda(p3, *rr, mode)
            old = bvh2.walk3_cuda_v1(p3, *rr, mode)
            torch.cuda.synchronize()
            twin = bvh2.walk3_twin(p3, *rr, mode)
            new_err[name] = k4_bars(f"K4 {mode} {label} vs twin", new, twin, T_ATOL, grazing)
            k4_bars(f"K4 {mode} {label} vs v1", new, old, T_ATOL, grazing)
            hit = (old[1] == twin[1]) & (twin[1] >= 0)
            k4_v1_err[name] = (old[0][hit] - twin[0][hit]).abs().max().item()
            k4_work_2n[name] = dict(bvh2.walk3_twin.work)  # the 2N set's, the last
            got = new[1] >= 0
            check(bool(((new[0][got] > rr[2][got]) & (new[0][got] < rr[3][got])).all())
                  and bool((new[1][rr[3] <= rr[2]] == -1).all()),
                  f"K4 {mode} {label}: every hit in (tnear, tfar), every dead lane a miss")
            if mode == "any":
                occ_same = got == (l3_latch >= 0)
                check(agree(got, l3_latch >= 0) >= K4_K3_BAR,
                      f"K4 any {label} vs K3's latch: occlusion agree "
                      f"{agree(got, l3_latch >= 0):.6f} (>= {K4_K3_BAR}; "
                      f"{int((~occ_same).sum())} lanes differ: {int((~occ_same & got).sum())} "
                      f"only K4 blocked; occluded {got.float().mean().item():.4f})")
                continue
            same = new[1] == l3
            check(agree(new[1], l3) >= K4_K3_BAR
                  and torch.equal(new[0][same].view(torch.int32), t3[same].view(torch.int32)),
                  f"K4 {mode} {label} vs exact K3: slot agree {agree(new[1], l3):.6f} (>= "
                  f"{K4_K3_BAR}; {int((~same).sum())} lanes differ), t bit for bit where it "
                  f"agrees (hits {(l3 >= 0).float().mean().item():.4f})")
    for name, _, mode, _, _ in NEW_KERNELS:
        log(f"  K4 {mode} 2N twin counts {k4_work_2n[name]}")
        turns(f"K4 {mode} 2N", lambda: bvh2.walk3_cuda_v1(p3, *r2, mode),
              lambda: bvh2.walk3_cuda(p3, *r2, mode), card)
    # K5 in both modes: the kernel equals its twin and its first CUDA form
    # (bvh_walk_v1.cu) bit for bit in t, slot, u and v on the three sets
    pv = scene.pbvh
    twin_2n_ms, work_2n = {}, {}  # json name -> the twin's ms / counts on the 2N batch
    first_err = {}  # json name -> the first form's largest |t| difference there
    for name, prune, mode in (("bvh_walk", True, "K5-v2"), ("bvh_walk_v1", False, "K5-v1")):
        for label, rr in with_mixed:
            new = bvh.walk_packet_cuda(pv, *rr, prune=prune)
            old = bvh.walk_packet_cuda_v1(pv, *rr, prune=prune)
            torch.cuda.synchronize()
            t0 = time.time()
            twin = bvh.walk_packet_twin(pv, *rr, prune=prune)
            torch.cuda.synchronize()
            twin_ms = (time.time() - t0) * 1e3
            check(same_bits(new, twin) and same_bits(new, old),
                  f"{mode} {label}: the kernel equals its twin and its first CUDA form bit for "
                  f"bit in t, slot, u, v (slot agree {agree(new[1], twin[1]):.6f} / "
                  f"{agree(new[1], old[1]):.6f}; hits {(new[1] >= 0).float().mean().item():.4f})")
        hit = twin[1] >= 0  # the 2N set's, the last
        new_err[name] = (new[0][hit] - twin[0][hit]).abs().max().item()
        first_err[name] = (old[0][hit] - twin[0][hit]).abs().max().item()
        twin_2n_ms[name], work_2n[name] = twin_ms, dict(bvh.walk_packet_twin.work)
        log(f"  {mode} 2N twin {twin_ms:.1f} ms (host clock); twin counts {work_2n[name]}")
    reset_counts()
    for label, prim in (("K4 ordered", bvh2.intersect_bvh3(scene.pbvh3, scene.tris, *sub).prim),
                        ("K4 skip", bvh2.intersect_bvh3(scene.pbvh3, scene.tris, *sub,
                                                        ordered=False).prim),
                        ("K5", bvh.intersect_bvh(pv, *sub).prim),
                        ("K5-v1", bvh.hit_from_local(pv, *bvh.walk_packet(
                            pv, *sub, prune=False)).prim)):
        check(agree(prim, hb.prim) >= BAR, f"8192 rays: {label} vs brute force prim agree "
              f"{agree(prim, hb.prim):.6f}")
    occ = bvh2.occluded_bvh3(scene.pbvh3, *sub)
    check(agree(occ, hb.prim >= 0) >= BAR, f"8192 rays: K4 any vs brute force occlusion agree "
          f"{agree(occ, hb.prim >= 0):.6f}")
    c = counts()
    check(all(c[f"bvh2.walk3_cuda.{m}"] == 1 for m in bvh2.MODES)
          and c["bvh.walk_packet_cuda.v2"] == 1 and c["bvh.walk_packet_cuda.v1"] == 1
          and not v1_launches(c) and not any(v for k, v in c.items() if "twin" in k),
          f"8192 rays: the queries launched the kernels once each, no first form and no "
          f"twin: {c}")

    # K2 on the same scene: against its twin by bars (its cull is per ray and
    # per sub-box, the twin's per tile), its first form bit for bit
    pt = scene.ptris
    log(f"[3c kernels] K2 on materialtest-synth: {pt.n_chunks} chunks of "
        f"{intersect_stream.CHUNK} triangles, sub-boxes of {intersect_stream.SUB}")

    def k2_vs_twin(label, out, twin):
        """K2's prim against its twin's on >= K2_BAR of the lanes; t, u, v
        bit for bit where the prims agree; the lanes that differ, counted."""
        same = out[1] == twin[1]
        kh, th = out[1] >= 0, twin[1] >= 0
        n_diff = int((~same).sum())
        check(same.float().mean().item() >= K2_BAR,
              f"K2 {label}: prim agrees with the twin on {same.float().mean().item():.6f} "
              f"(>= {K2_BAR}); {n_diff} lanes differ: {int((~same & ~kh).sum())} the kernel "
              f"missed, {int((~same & ~th).sum())} the twin missed, "
              f"{int((~same & kh & th).sum())} another triangle")
        check(all(torch.equal(x[same].view(torch.int32), y[same].view(torch.int32))
                  for x, y in ((out[0], twin[0]), (out[2], twin[2]), (out[3], twin[3]))),
              f"K2 {label}: t, u, v bit for bit the twin's where the prims agree")
        return n_diff

    k2_diff = {}
    for label, rr in with_mixed:
        new = intersect_stream.stream_cuda(pt, *rr)
        old = intersect_stream.stream_cuda_v1(pt, *rr)
        torch.cuda.synchronize()
        t0 = time.time()
        twin = intersect_stream.stream_twin(pt, *rr)
        torch.cuda.synchronize()
        twin_ms = (time.time() - t0) * 1e3
        check(same_bits(old, twin), f"K2 first form {label}: equals the twin bit for bit "
              f"(prim agree {agree(old[1], twin[1]):.6f})")
        k2_diff[label] = k2_vs_twin(label, new, twin)
    hit = (new[1] == twin[1]) & (twin[1] >= 0)  # the 2N set's, the last
    new_err["intersect_stream"] = (new[0][hit] - twin[0][hit]).abs().max().item()
    first_err["intersect_stream"] = (old[0][twin[1] >= 0] - twin[0][twin[1] >= 0]).abs().max().item()
    twin_2n_ms["intersect_stream"], work_2n["intersect_stream"] = twin_ms, dict(
        intersect_stream.stream_twin.work)
    w2 = work_2n["intersect_stream"]
    w2.update(intersect_stream.sub_box_work(pt, *r2))
    log(f"  K2 2N twin {twin_ms:.1f} ms (host clock); twin counts and what the sub-box "
        f"cull leaves {w2}: the tiles run {w2['tri_tile'] / w2['tri']:.4f}x the triangle tests "
        f"of the chunks the rays hit, those {w2['tri'] / max(w2['tri_sub'], 1):.4f}x the "
        f"triangles of the sub-boxes they hit")
    reset_counts()
    h = intersect_stream.intersect_stream(pt, *sub)
    check(agree(h.prim, hb.prim) >= BAR, f"8192 rays: K2 vs brute force prim agree "
          f"{agree(h.prim, hb.prim):.6f}")
    c = counts()
    check(c["intersect_stream.stream_cuda"] == 1 and not v1_launches(c)
          and not any(v for k, v in c.items() if "twin" in k),
          f"8192 rays: the query launched K2 once, no first form and no twin: {c}")
    # the new kernels against their first forms on the 2N batch, in turns
    turns("K5-v2 2N", lambda: bvh.walk_packet_cuda_v1(pv, *r2),
          lambda: bvh.walk_packet_cuda(pv, *r2), card)
    turns("K5-v1 2N", lambda: bvh.walk_packet_cuda_v1(pv, *r2, prune=False),
          lambda: bvh.walk_packet_cuda(pv, *r2, prune=False), card)
    turns("K2 2N", lambda: intersect_stream.stream_cuda_v1(pt, *r2),
          lambda: intersect_stream.stream_cuda(pt, *r2), card)

    # K3-fast on the same pack: raw kernel vs twin, the whole query, the repair
    log("[3d K3-fast] the bf16x3 walk (bvh8_walk_fast.cu) and its exact repair")
    fast_sets = cases + ((f"closest 2N={2 * n_pix}", r2),)
    repair_far = []  # the tfar each query hands its repair launch

    def repair_walk(pack, o, d, tnear, tfar):
        repair_far.append(tfar)
        return bvh8.walk_cuda(pack, o, d, tnear, tfar)

    atol_all = T_ATOL_ALL_GRAZING_PER_EXTENT * extent
    reset_counts()
    for label, rr in fast_sets:
        tk, lk = bvh8.walk_fast_cuda(pack, *rr)
        tv, lv = bvh8.walk_fast_cuda_v1(pack, *rr)
        torch.cuda.synchronize()
        tt, lt = bvh8.walk_fast_twin(pack, *rr)
        check(torch.equal(lv, lt) and torch.equal(tv, tt),
              f"K3-fast v1 {label}: raw kernel equals its twin bit for bit (slot agree "
              f"{agree(lv, lt):.6f})")
        fast_err = fast_bars(f"{label} vs twin", tk, lk, tt, lt, T_ATOL, atol_all)
        fast_bars(f"{label} vs v1", tk, lk, tv, lv, T_ATOL, atol_all)
        v1_same = (lv == lt) & (lt >= 0)
        fast_v1_err = (tv[v1_same] - tt[v1_same]).abs().max().item()  # the 2N set's, the last
        hf = bvh8.intersect(pack, scene.tris, *rr, walks=(bvh8.walk_fast_cuda, repair_walk))
        ph = repair_far[-1] > 0.0  # the phantoms: winners that failed the exact validation
        he = bvh8.intersect(pack, scene.tris, *rr, fast=False)
        n_ph = int(ph.sum())
        log(f"  K3-fast {label}: {n_ph} phantoms = repair lanes ({n_ph / lk.shape[0]:.4%} of "
            f"{lk.shape[0]} lanes); the repair found a hit for {int((hf.prim[ph] >= 0).sum())}, "
            f"a miss for {int((hf.prim[ph] < 0).sum())}")
        # the cube stands on the floor quad: where two coincident triangles tie
        # (both hit, the same t), either prim is the closest hit
        tie = ((hf.prim >= 0) & (he.prim >= 0)
               & torch.isclose(hf.t, he.t, rtol=T_RTOL, atol=T_ATOL))
        same_hit = ((hf.prim == he.prim) | tie).float().mean().item()
        check(same_hit >= FAST_BAR, f"K3-fast {label}: fast query vs exact query agree "
              f"{same_hit:.6f} (>= {FAST_BAR}; the same prim on {agree(hf.prim, he.prim):.6f}, "
              f"the rest ties of coincident triangles at one t)")
        same = (hf.prim == he.prim) & (he.prim >= 0)
        # two f32 formulas for one hit: Moller-Trumbore (the fast query's
        # validation) and the plane form (the exact walk's own t); on grazing
        # hits they part, so only the share inside the bar is held
        near = torch.isclose(hf.t[same], he.t[same], rtol=T_RTOL, atol=T_ATOL).float().mean().item()
        check(near >= BAR, f"K3-fast {label}: query t (Moller-Trumbore) vs exact query t "
              f"(plane form) within rtol {T_RTOL} atol {T_ATOL:.2g} on {near:.6f} (>= {BAR}); "
              f"max abs difference {(hf.t[same] - he.t[same]).abs().max().item():.3e}")
        if label.startswith("camera"):
            check(n_ph > 0, "K3-fast camera: the slack accepts some phantoms (0 would mean "
                  "the slack is not applied)")
    fast_work = dict(bvh8.walk_fast_twin.work)  # of the 2N set, the last
    c = counts()
    check(c["bvh8.walk_fast_cuda"] == 2 * len(fast_sets) and c["bvh8.walk_fast_twin"] ==
          len(fast_sets) and c["bvh8.walk_fast_cuda_v1"] == len(fast_sets),
          f"K3-fast: the kernel launched {c['bvh8.walk_fast_cuda']} times (raw + query per "
          f"set), its twin {c['bvh8.walk_fast_twin']} and v1 {c['bvh8.walk_fast_cuda_v1']} "
          f"(the comparisons)")
    hf = bvh8.intersect(pack, scene.tris, *sub)
    check(agree(hf.prim, hb.prim) >= BAR, f"8192 rays: K3-fast query vs brute force prim agree "
          f"{agree(hf.prim, hb.prim):.6f}")
    # the 2N set's repair launch, exact K3 against its twin: closest hit with
    # tfar = 0 on every lane but the phantoms
    far_rep, need2 = repair_far[-1], ph
    tk, lk = bvh8.walk_cuda(pack, o2, d2, n2, far_rep)
    torch.cuda.synchronize()
    tt, lt = bvh8.walk_twin(pack, o2, d2, n2, far_rep)
    check(bool((lk[~need2] < 0).all()) and agree(lk[need2], lt[need2]) >= BAR,
          f"2N repair launch ({int(need2.sum())} live lanes): K3 kernel vs twin slot agree "
          f"{agree(lk[need2], lt[need2]):.6f} on the live lanes, a miss on every other")
    check(same_bits((tk, lk), bvh8.walk_cuda_v1(pack, o2, d2, n2, far_rep)),
          "2N repair launch: K3 equals its v1 form bit for bit")
    same = (lk == lt) & (lk >= 0)
    check(t_close(tk[same], tt[same], T_ATOL, atol_all), f"2N repair launch: t within rtol "
          f"{T_RTOL} atol {T_ATOL:.2g} (>= {BAR}), rtol {T_RTOL_ALL} atol {atol_all:.2g} (all); "
          f"max abs err "
          f"{(tk[same] - tt[same]).abs().max().item():.3e}")
    fast_v1_ms, fast_ms = turns("K3-fast 2N closest", lambda: bvh8.walk_fast_cuda_v1(pack, *r2),
                                lambda: bvh8.walk_fast_cuda(pack, *r2), card)
    fast_ms_b2b = cuda_ms(lambda: bvh8.walk_fast_cuda(pack, *r2), reps=10)
    fast_v1_ms_b2b = cuda_ms(lambda: bvh8.walk_fast_cuda_v1(pack, *r2), reps=10)
    exact_v1_ms, exact_ms = turns("K3 2N closest", lambda: bvh8.walk_cuda_v1(pack, *r2),
                                  lambda: bvh8.walk_cuda(pack, *r2), card)
    repair_v1_ms, repair_ms = turns(
        "K3 2N repair launch", lambda: bvh8.walk_cuda_v1(pack, o2, d2, n2, far_rep),
        lambda: bvh8.walk_cuda(pack, o2, d2, n2, far_rep), card)
    query_ms = cuda_ms(lambda: bvh8.intersect(pack, scene.tris, *r2), reps=5)
    exact_query_ms = cuda_ms(lambda: bvh8.intersect(pack, scene.tris, *r2, fast=False), reps=5)
    fast_plain_ms = cuda_ms(lambda: bvh8.walk_fast_twin(pack, *r2), reps=1)
    log(f"[3d K3-fast] closest-hit 2N={2 * n_pix} on {card}: fast kernel {fast_ms:.3f} ms, "
        f"exact K3 kernel {exact_ms:.3f} ms (the fast walk {exact_ms / fast_ms:.2f}x as fast); "
        f"v1 forms {fast_v1_ms:.3f} and {exact_v1_ms:.3f} ms; fast kernel 10 back to back "
        f"{fast_ms_b2b:.3f} ms, v1 {fast_v1_ms_b2b:.3f}; twin {fast_plain_ms:.3f} ms; "
        f"repair launch "
        f"({int(need2.sum())} live "
        f"lanes) {repair_ms:.3f} ms; whole fast query {query_ms:.3f} ms, whole exact query "
        f"{exact_query_ms:.3f} ms; twin counts {fast_work}")
    fast_bytes = (nbytes(o2, d2, n2, f2, pack.boxes, pack.kid_t, pack.order_t,
                         pack.tri_planes_hi, pack.tri_planes_lo) + 8 * o2.shape[0])

    k1 = k1_phase(scene, v1_cases, r2, latch, sub, hb, n_pix, card)

    # small renders against the JAX package's means
    with numpy_bvh_build():
        render_vs_ref("4 small", synth.write_scene(os.path.join(work, "small"), "small"),
                      "torch_port_small_ref.json", dev)
        render_vs_ref("4b analytic",
                      synth.write_scene(os.path.join(work, "sa"), "small-analytic"),
                      "torch_port_analytic_ref.json", dev)
        for size, ref_file in (("small-area", "torch_port_area_ref.json"),
                               ("small-box", "torch_port_box_ref.json")):
            small_path = synth.write_scene(os.path.join(work, size), size)
            for wavefront in ("regen", "lockstep"):
                render_vs_ref("4c lights", small_path, ref_file, dev, wavefront)

    # the full slice: materialtest-synth, 1000x563, 32 spp
    log("[5 slice] load_scene + flatten_scene + render_flat of materialtest-synth")
    scene = flatten_scene(load_scene(big_path), dev)
    spp = scene.meta.spp
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    img = render_flat(scene, spp=spp, seed=DEFAULT_SEED)
    dt = time.time() - t0
    launches, twin = bvh8.walk_cuda.launches, bvh8.walk_twin.launches
    v1 = v1_launches(counts())
    check(launches > 0 and twin == 0 and v1 == 0,
          f"slice: kernel launches {launches}, twin {twin}, v1 kernels {v1}")
    check(img.shape == (meta.res_y, meta.res_x, 3) and np.isfinite(img).all()
          and (img >= 0).all(), f"slice: {img.shape} image finite and non-negative")
    check(0.0 < float(img.mean()) < 1e3, f"slice: image mean {img.mean():.6f}")
    rate = n_pix * spp / dt / 1e6
    log(f"[5 slice] materialtest-synth {meta.res_x}x{meta.res_y} {spp} spp in {dt:.2f} s: "
        f"{rate:.4f} Mpaths/s on {card}")

    # the lockstep slice at full width: materialtest-area
    area_path = synth.write_scene(os.path.join(work, "mtarea"), "materialtest-area")
    t0 = time.time()
    area = flatten_scene(load_scene(area_path), dev)
    am = area.meta
    log(f"[5b lockstep] materialtest-area flattened in {time.time() - t0:.1f} s: "
        f"{area.tris.v0.shape[0]} triangles, {am.n_lights} lights {area.lights.apx_kind}; "
        f"{am.res_x}x{am.res_y}, {am.spp} spp, max_bounces {am.max_bounces}")
    area_imgs = {}
    for wavefront in ("lockstep", "regen"):
        spp_w = AREA_LOCKSTEP_SPP if wavefront == "lockstep" else am.spp
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        img = render_flat(area, spp=spp_w, seed=DEFAULT_SEED, wavefront=wavefront)
        dt = time.time() - t0
        c = counts()
        k3_only(f"materialtest-area {wavefront}", c)
        if wavefront == "lockstep":
            # per pass 1 camera walk + one 2N walk per bounce run, each with
            # its repair launch; one shadow walk per bounce run
            lock_fast, lock_exact = c["bvh8.walk_fast_cuda"], c["bvh8.walk_cuda"]
            check_lockstep_launches("lockstep", lock_fast, lock_exact, spp_w, am.max_bounces)
        check(img.shape == (am.res_y, am.res_x, 3) and np.isfinite(img).all()
              and (img >= 0).all(), f"{wavefront}: {img.shape} image finite and non-negative")
        log(f"[5b lockstep] materialtest-area {wavefront}: {am.res_x}x{am.res_y} {spp_w} spp in "
            f"{dt:.2f} s: {am.res_x * am.res_y * spp_w / dt / 1e6:.4f} Mpaths/s on {card}")
        area_imgs[wavefront] = img.reshape(-1, 3).astype(np.float64).mean(0)
    rel = np.abs(area_imgs["lockstep"] - area_imgs["regen"]) / np.abs(area_imgs["regen"])
    check((rel <= WAVEFRONT_RTOL).all(), f"materialtest-area: lockstep channel means "
          f"{area_imgs['lockstep'].round(6).tolist()} vs regen's "
          f"{area_imgs['regen'].round(6).tolist()} (rel {rel.max():.2e} <= {WAVEFRONT_RTOL})")

    # the intersector benchmark: every walk on the same rays
    log("[6 isect] tungsten_tpu_torch.tools.bench_isect on materialtest-synth, n = 131072")
    reset_counts()
    t0 = time.time()
    bench_kernels = bench_isect.KERNELS + bench_isect.V1_KERNELS
    res = bench_isect.run(big_path, dev, n=131072, kernels=bench_kernels, trials=5)
    bench_launches = counts()
    bench_isect.report(res)
    k2_work = res["times"][("coherent", "tri")]["work"]
    log(f"[6 isect] K2 twin counts on the coherent rays {k2_work}: the tiles run "
        f"{k2_work['tri_tile'] / k2_work['tri']:.4f}x the triangle tests of the chunks the rays "
        f"hit, those {k2_work['tri'] / max(k2_work['tri_sub'], 1):.4f}x the triangles of the "
        f"sub-boxes they hit")
    n_walks = len(bench_kernels)
    check(len(res["times"]) == 3 * n_walks and all(
        r["ms"] > 0.0 and r["twin_ms"] > 0.0 for r in res["times"].values()),
        f"isect: kernel and twin times for 3 ray kinds x {n_walks} walks in "
        f"{time.time() - t0:.1f} s")
    check(min(res["agree"].values()) >= BAR, f"isect: all {len(res['agree'])} agreements >= "
          f"{BAR} (lowest {min(res['agree'].values()):.6f})")
    new_keys = [f"bvh2.walk3_cuda.{m}" for m in bvh2.MODES] + [
        *(f"bvh2.walk3_cuda_v1.{m}" for m in bvh2.MODES),
        "bvh.walk_packet_cuda.v2", "bvh.walk_packet_cuda.v1", "intersect_stream.stream_cuda",
        "bvh8.walk_fast_cuda", "bvh8.walk_cuda_v1", "bvh8.walk_fast_cuda_v1",
        "bvh.walk_packet_cuda_v1.v2", "bvh.walk_packet_cuda_v1.v1",
        "intersect_stream.stream_cuda_v1", "gather_bvh.walk_cuda"]
    check(all(bench_launches[k] > 0 for k in new_keys),
          f"isect: K4 / K5 / K2 / K3-fast / v1 / K1 launches "
          f"{[bench_launches[k] for k in new_keys]}")
    bscene = bench_isect.load(big_path, dev)
    p8, bp3, bpv, bpt = bscene.pbvh8, bscene.pbvh3, bscene.pbvh, bscene.ptris
    for ray_kind in ("coherent", "incoherent"):
        br = bench_isect.make_rays(bscene, 131072, ray_kind)
        for mode in bvh2.MODES:
            turns(f"K4 {mode} {ray_kind} 131072", lambda: bvh2.walk3_cuda_v1(bp3, *br, mode),
                  lambda: bvh2.walk3_cuda(bp3, *br, mode), card)
        turns(f"K3 closest {ray_kind} 131072", lambda: bvh8.walk_cuda_v1(p8, *br),
              lambda: bvh8.walk_cuda(p8, *br), card)
        turns(f"K3 latched {ray_kind} 131072", lambda: bvh8.walk_cuda_v1(p8, *br, latch=True),
              lambda: bvh8.walk_cuda(p8, *br, latch=True), card)
        turns(f"K3-fast {ray_kind} 131072", lambda: bvh8.walk_fast_cuda_v1(p8, *br),
              lambda: bvh8.walk_fast_cuda(p8, *br), card)
        turns(f"K5-v2 {ray_kind} 131072", lambda: bvh.walk_packet_cuda_v1(bpv, *br),
              lambda: bvh.walk_packet_cuda(bpv, *br), card)
        turns(f"K5-v1 {ray_kind} 131072", lambda: bvh.walk_packet_cuda_v1(bpv, *br, prune=False),
              lambda: bvh.walk_packet_cuda(bpv, *br, prune=False), card)
        turns(f"K2 {ray_kind} 131072", lambda: intersect_stream.stream_cuda_v1(bpt, *br),
              lambda: intersect_stream.stream_cuda(bpt, *br), card)

    # the render's three intersector routes on one flattened scene
    ana_path = synth.write_scene(os.path.join(work, "mta"), "materialtest-analytic")
    t0 = time.time()
    full = flatten_scene(load_scene(ana_path), dev)
    m = full.meta
    log(f"[7 routes] materialtest-analytic flattened in {time.time() - t0:.1f} s: "
        f"{full.tris.v0.shape[0]} triangles, {full.ana.n} analytic prims; "
        f"{m.res_x}x{m.res_y}, {m.spp} spp")
    routes = (  # K3's closest-hit walks go through K3-fast and its repair
        ("K3", "bvh8.walk_cuda", full),
        ("K1", "gather_bvh.walk_cuda", dataclasses.replace(full, pbvh8=None)),
        ("K5-v2", "bvh.walk_packet_cuda.v2",
         dataclasses.replace(full, pbvh8=None, gbvh=None, pbvh3=None)),
        ("K2", "intersect_stream.stream_cuda",
         dataclasses.replace(full, pbvh8=None, gbvh=None, pbvh3=None, pbvh=None)),
    )
    imgs, route_launches = {}, {}
    for label, key, sc in routes:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        img = render_flat(sc, spp=m.spp, seed=DEFAULT_SEED)
        dt = time.time() - t0
        c = counts()
        allowed = (key, "bvh8.walk_fast_cuda") if label == "K3" else (key,)
        others = {k: v for k, v in c.items() if k not in allowed and v}
        check(c[key] > 0 and not others, f"route {label}: {key} launched {c[key]} times, "
              f"every other walk and twin none {others}")
        check(img.shape == (m.res_y, m.res_x, 3) and np.isfinite(img).all() and (img >= 0).all(),
              f"route {label}: image finite and non-negative")
        log(f"[7 routes] {label}: {m.res_x}x{m.res_y} {m.spp} spp in {dt:.2f} s: "
            f"{m.res_x * m.res_y * m.spp / dt / 1e6:.4f} Mpaths/s on {card}")
        imgs[label], route_launches[label] = img, c[key]
    ref_img = imgs["K3"]
    ref_means = ref_img.reshape(-1, 3).astype(np.float64).mean(0)
    for label in ("K1", "K5-v2", "K2"):
        img = imgs[label]
        means = img.reshape(-1, 3).astype(np.float64).mean(0)
        rel = np.abs(means - ref_means) / np.abs(ref_means)
        check((rel <= MEAN_RTOL).all(), f"route {label}: channel means "
              f"{means.round(6).tolist()} vs K3's {ref_means.round(6).tolist()} "
              f"(rel {rel.max():.2e} <= {MEAN_RTOL})")
        close = np.all(np.abs(img - ref_img) <= PIX_ATOL + PIX_RTOL * np.abs(ref_img), axis=-1)
        check(close.mean() >= PIX_BAR, f"route {label}: {close.mean():.6f} of pixels within "
              f"{PIX_ATOL} + {PIX_RTOL} |K3| (>= {PIX_BAR})")

    interior_launches = interior_phase(work, dev, card)
    surface_launches, _ = surfaces_phase(work, dev, card)
    light_launches = lights_phase(work, dev, card)
    camera_launches = camera_phase(work, dev, card)
    k6, media_launches = media_phase(work, dev, card)
    bdpt_launches, box_pt = bdpt_phase(work, dev, card)
    sppm_launches, sppm_all, k7 = sppm_phase(work, dev, card, box_pt)

    def entry(name, source, replaces, n_launch, err, t_ms, t_plain, n_bytes, ops, bf16_ops=0):
        b_ms, b_by = bound(n_bytes, ops, bf16_ops)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": t_ms, "plain_ms": t_plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    entries = [entry("bvh8_walk", "tungsten_tpu_torch/csrc/bvh8_walk.cu",
                     "tungsten_tpu/ops/pallas_bvh8.py:130", launches, max_abs_err, ms, plain_ms,
                     k3_bytes, k3_work["box"] * OPS["box"] + k3_work["tri"] * OPS["plane"])]
    fast_entry = entry("bvh8_walk_fast", "tungsten_tpu_torch/csrc/bvh8_walk_fast.cu",
                       "tungsten_tpu/ops/pallas_bvh8.py:67", lock_fast, fast_err, fast_ms,
                       fast_plain_ms, fast_bytes,
                       fast_work["box"] * OPS["box"] + fast_work["tri"] * OPS["plane_bf16x3"],
                       fast_work["tri"] * OPS["plane_bf16x3_mma"])
    fast_entry["exact_k3_ms"] = exact_ms
    entries.append(fast_entry)
    for row, key in zip(entries, ("bvh8.walk_cuda", "bvh8.walk_fast_cuda")):
        row["launches_interior"] = {w: c[key] for w, c in interior_launches.items()}
        row["launches_surfaces"] = {w: c[key] for w, c in surface_launches.items()}
        row["launches_lights"] = {w: c[key] for w, c in light_launches.items()}
        row["launches_camera"] = {w: c[key] for w, c in camera_launches.items()}
        row["launches_media"] = {w: c[key] for w, c in media_launches.items()}
        row["launches_lt"] = bdpt_launches["light_tracer"][key]
        row["launches_bdpt"] = bdpt_launches["bidirectional_path_tracer"][key]
        row["launches_sppm"] = {w: c[key] for w, c in sppm_all.items()}
    # K1: XLA gathers on the TPU, no pl.pallas_call; its launches from the
    # phase-7 K1 route render, its times and bound on the 2N batch (phase 3e)
    k1_row = entry("gather_walk", "tungsten_tpu_torch/csrc/gather_walk.cu",
                   "tungsten_tpu/ops/gather_bvh.py:216", route_launches["K1"], k1["err"],
                   k1["ms"], k1["plain_ms"], k1["bytes"], k1["ops"])
    k1_row["tpu_form"] = "XLA gathers (`_phase`), not pl.pallas_call"
    k1_row["exact_k3_ms"], k1_row["twin_rounds"] = k1["k3_ms"], k1["work"]
    entries.append(k1_row)
    # K6: XLA lax.while_loop on the TPU, no pl.pallas_call; its launches from
    # the media-synth cloud regen render, its times and bound on the largest
    # tau launch of the cloud's 1-spp regen pass (the render's own lanes),
    # the other launches beside
    r = k6["render_tau"]
    k6_row = entry("grid_walk", "tungsten_tpu_torch/csrc/grid_walk.cu",
                   "tungsten_tpu/models/grids/grid.py:156", k6["launches"],
                   max(v["err"] for k, v in k6.items() if isinstance(v, dict) and "err" in v),
                   r["ms"], r["plain_ms"], r["bytes"], r["ops"])
    k6_row["tpu_form"] = "XLA lax.while_loop (`_dda_cells` + folds), not pl.pallas_call"
    k6_row["lanes"], k6_row["walking"], k6_row["twin_rounds"] = r["n"], r["walking"], r["work"]
    for key in ("render_inverse", "random_tau", "random_inverse"):
        if key in k6:
            k6_row[key] = {f: k6[key][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "n",
                                                   "walking", "work")}
    k6_row["launches_media"] = {w: c["grid_walk.walk_cuda"] for w, c in media_launches.items()}
    k6_row["one_pass"] = k6["pass"]
    entries.append(k6_row)
    # K7: XLA loops on the TPU, no pl.pallas_call; its launches from the
    # box-synth progressive_photon_map render, its times and bound on that
    # render's first surface call, each checked call's beside
    r = k7["surface (progressive_photon_map)"]
    k7_row = entry("photon_walk", "tungsten_tpu_torch/csrc/photon_walk.cu",
                   "tungsten_tpu/integrators/photon_map.py:1255", sppm_launches[
                       "photon_walk.walk_cuda"], max(v["err"] for v in k7.values()), r["ms"],
                   r["plain_ms"], r["bytes"], r["ops"])
    k7_row["tpu_form"] = ("XLA loops (`cell_body` / `hist_body` :1221-1280, the DDAs of "
                          "`_volume_beam_gather` :966 and `_beam1d_gather` :482), not "
                          "pl.pallas_call")
    k7_row["calls"] = {label: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "work")} for label, v in k7.items()}
    k7_row["launches_sppm"] = {w: c["photon_walk.walk_cuda"] for w, c in sppm_all.items()}
    entries.append(k7_row)
    for row, b2b in zip(entries, (ms_b2b, fast_ms_b2b)):
        row["back_to_back_ms"] = b2b
    n_bench = res["n"]
    # K3's and K3-fast's first forms: the benchmark's coherent rays, where
    # their launches come from; their 2N times and bounds beside
    p8_io = nbytes(p8.boxes, p8.kid_t, p8.order_t) + n_bench * (32 + 8)
    for name, bname, key, replaces, err, t2n, b2b, io, b2n in (
            ("bvh8_walk_v1", "bvh8v1", "bvh8.walk_cuda_v1", "tungsten_tpu/ops/pallas_bvh8.py:130",
             v1_err, v1_ms, v1_ms_b2b, p8_io + nbytes(p8.tri_planes), entries[0]["bound_ms"]),
            ("bvh8_walk_fast_v1", "bvh8fastv1", "bvh8.walk_fast_cuda_v1",
             "tungsten_tpu/ops/pallas_bvh8.py:67", fast_v1_err, fast_v1_ms, fast_v1_ms_b2b,
             p8_io + nbytes(p8.tri_planes_hi, p8.tri_planes_lo), entries[1]["bound_ms"])):
        r = res["times"][("coherent", bname)]
        w = r["work"]
        if bname == "bvh8v1":
            ops, bf16_ops = w["box"] * OPS["box"] + w["tri"] * OPS["plane"], 0
        else:
            ops = w["box"] * OPS["box"] + w["tri"] * OPS["plane_bf16x3"]
            bf16_ops = w["tri"] * OPS["plane_bf16x3_mma"]
        row = entry(name, f"tungsten_tpu_torch/csrc/{name}.cu", replaces, bench_launches[key], err,
                    r["ms"], r["twin_ms"], io, ops, bf16_ops)
        row["ms_2n"], row["back_to_back_ms_2n"], row["bound_2n_ms"] = t2n, b2b, b2n
        entries.append(row)
    # K4: the benchmark's coherent rays, where its launches come from; in
    # each mode the first form's time (v1_ms), the 2N turns and bound beside,
    # and the first form's own row, on the same rays
    k4_io = nbytes(p3.box_t, p3.ni_t, p3.tri_planes)
    for name, bname, mode, source, replaces in NEW_KERNELS:
        r = res["times"][("coherent", bname)]
        ops = r["work"]["box"] * OPS["box"] + r["work"]["tri"] * OPS["plane"]
        row = entry(name, source, replaces, bench_launches[f"bvh2.walk3_cuda.{mode}"],
                    new_err[name], r["ms"], r["twin_ms"], k4_io + n_bench * (32 + 8), ops)
        entries.append(row)
        w2 = k4_work_2n[name]
        bound_2n = bound(k4_io + o2.shape[0] * (32 + 8),
                         w2["box"] * OPS["box"] + w2["tri"] * OPS["plane"])[0]
        first_ms, new_ms = TURNS[f"K4 {mode} 2N"]
        v1_bench = res["times"][("coherent", f"{bname}v1")]
        row["v1_ms"] = v1_bench["ms"]
        row["ms_2n"], row["v1_ms_2n"], row["bound_2n_ms"] = new_ms, first_ms, bound_2n
        row = entry(f"bvh2_walk_v1_{mode}", "tungsten_tpu_torch/csrc/bvh2_walk_v1.cu", replaces,
                    bench_launches[f"bvh2.walk3_cuda_v1.{mode}"], k4_v1_err[name],
                    v1_bench["ms"], v1_bench["twin_ms"], k4_io + n_bench * (32 + 8), ops)
        row["ms_2n"], row["bound_2n_ms"] = first_ms, bound_2n
        entries.append(row)
    # K5-v2 and K2: ms (the turns' mean), plain ms and bound on the 2N batch,
    # the batch of the route renders that give their launches; the
    # benchmark's coherent ms beside as bench_ms. K5-v1 and the first forms
    # of K5-v2 and K2: ms, plain ms and bound on the benchmark's coherent rays
    # (n_bench), where their launches come from; their 2N time and bound
    # beside as ms_2n and bound_2n_ms. A first form's bound is its new
    # kernel's: the same function on the same rays.
    def k5_k2_ops(w, k2):
        if not k2:
            return w["box"] * OPS["box"] + w["tri"] * OPS["mt"]
        return (w["box"] + w["box_sub"]) * OPS["box"] + sum(
            w[f"mt_{st}"] * OPS[f"mt_{st}"] for st in intersect_stream.MT_STAGES)

    n2 = o2.shape[0]
    pack_io = {"bvh": nbytes(pv.box_t, pv.ni_t, pv.tri_t),
               "tri": nbytes(pt.tri_p, pt.clusters, pt.sub_boxes),
               "bvhv1": nbytes(pv.box_t, pv.ni_t, pv.tri_t), "triv1": nbytes(pt.tri_c, pt.clusters)}
    bench_io = {"bvh": nbytes(bpv.box_t, bpv.ni_t, bpv.tri_t),
                "tri": nbytes(bpt.tri_p, bpt.clusters, bpt.sub_boxes),
                "triv1": nbytes(bpt.tri_c, bpt.clusters)}
    bench_io["bvhv1"] = bench_io["bvh"]
    route_launches_of = {"bvh": route_launches["K5-v2"], "tri": route_launches["K2"]}
    bench_launches_of = {"bvh1": bench_launches["bvh.walk_packet_cuda.v1"],
                         "bvhv1": bench_launches["bvh.walk_packet_cuda_v1.v2"],
                         "triv1": bench_launches["intersect_stream.stream_cuda_v1"]}
    turn_of = {"bvh": "K5-v2 2N", "bvh1": "K5-v1 2N", "tri": "K2 2N"}
    for name, bname, source, replaces, v1_name, v1_bname in K5_K2:
        k2 = bname == "tri"
        w2n = work_2n[name]
        wb = res["times"][("coherent", bname)]["work"]
        first_ms, new_ms = TURNS[turn_of[bname]]
        io_key = "tri" if k2 else "bvh"
        bound_2n = bound(pack_io[io_key] + n2 * (32 + 16), k5_k2_ops(w2n, k2))[0]
        bench = res["times"][("coherent", bname)]
        if bname in route_launches_of:  # the 2N batch
            row = entry(name, source, replaces, route_launches_of[bname], new_err[name], new_ms,
                        twin_2n_ms[name], pack_io[io_key] + n2 * (32 + 16), k5_k2_ops(w2n, k2))
            row["bench_ms"] = bench["ms"]
            row["v1_ms"] = first_ms
            if k2:  # the chunk-level bound of earlier PRs, to continue the series
                row["bound_chunk_ms"] = bound(pack_io["triv1"] + n2 * (32 + 16),
                                              w2n["box"] * OPS["box"] + w2n["tri"] * OPS["mt"])[0]
        else:  # the benchmark's coherent rays
            row = entry(name, source, replaces, bench_launches_of[bname], new_err[name],
                        bench["ms"], bench["twin_ms"], bench_io[io_key] + n_bench * (32 + 16),
                        k5_k2_ops(wb, k2))
            row["v1_ms"] = res["times"][("coherent", v1_bname)]["ms"]
            row["ms_2n"], row["v1_ms_2n"], row["bound_2n_ms"] = new_ms, first_ms, bound_2n
        entries.append(row)
        if v1_name:
            v1_bench = res["times"][("coherent", v1_bname)]
            row = entry(v1_name, source.replace(".cu", "_v1.cu"), replaces,
                        bench_launches_of[v1_bname], first_err[name], v1_bench["ms"],
                        v1_bench["twin_ms"], bench_io[v1_bname] + n_bench * (32 + 16),
                        k5_k2_ops(wb, k2))
            row["ms_2n"], row["bound_2n_ms"] = first_ms, bound_2n
            entries.append(row)
    log("[turns] v1 against new, ms, " + card + ": " + json.dumps(
        {k: [round(a, 4), round(b, 4)] for k, (a, b) in TURNS.items()}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
