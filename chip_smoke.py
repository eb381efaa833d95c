#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aleo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py kernels    # only the named phases (device always runs)
    python3 chip_smoke.py mesh sdk   # the multi-device layer and the host SDK
    python3 chip_smoke.py serve      # the dev server, the worker and the CLI
    python3 chip_smoke.py credits    # credits.aleo's three shapes against the JAX package
    python3 chip_smoke.py bench      # aleo_tpu_torch/bench.py's sizes, held first
    python3 chip_smoke.py scan_widths  # opt-in: the scan's two ECDH paths by width

Phases, each printing one JSON line with its seconds:

  device    the card's name and power limit; builds the CUDA kernels from
            aleo_tpu_torch/csrc/ with nvcc
  kernels   fq_prepare, fq_mul, fq_apply each against its plain PyTorch
            version on the card (exact equality after normalize) at the lane
            grid of a 32768-point MSM, edge-case lanes planted among random
            ones; fq_mul also at 1, 2, 31, 33, 127, 129, 1001 and 180224
            lanes, operands at 2p and 2p - 1 planted at both ends, its
            stored limbs equal to the plain version's, timed at 2, 128 and
            180224 lanes too; fq_apply also at 1, 127, 129, 1001 and 180224 lanes with
            every case code planted (from 8 lanes on), its stored limbs
            equal to the plain version's and kept lanes bit for bit, timed
            at 128 lanes too; fq_inv_up, fq_fermat (safegcd) and fq_inv_down, the batch
            inversion's three kernels, against theirs at that grid, at 1,
            129 and 1001 lanes and at the 180224 lanes of msm_batch_host
            (two levels of tiles), with 1, 2, p - 1, p + 1, 2p - 1, powers of
            two and R mod p planted; fq_fermat also at 50 and 128 lanes (the
            tree's roots); then batch_inv_lf (its launches counted) and madd
            whole against host inverses and the plain madd. fmat_reduce,
            fmat_carry2d and fmat_carry3d each against its plain version
            (exact equality of the int8 limbs) at the shapes of one stage of
            a 2^17 transform, on the columns of real products with the hard
            columns planted among them; the two library products of MatNTT
            (`torch._int_mm`, float32 `torch.bmm`) against a float64 product
            on the card and an int64 product on the host. `ms` is a kernel's
            device time (replays of a captured CUDA graph over buffers larger
            than the L2 cache); `plain_ms`, `madd_ms` and `batch_inv_lf_ms`
            are whole calls, host side included. g1_double, g1_add,
            g1_add_sel, g1_add_sel_proj and g1_normalize each against its
            plain version (exact equality after normalize; masked lanes bit
            for bit) at the 45056 lanes of a 32768-point projective MSM and
            at the ragged widths 1, 22, 129 and 1001, with P + P, P + (-P),
            identities (z as 0 and as p), the (0, 0) sentinel, invalid lanes
            and lazy representatives planted among random lanes; at 22 lanes
            also real curve points against the host group law. g1_double
            (a lane over four threads) also at 31, 33, 704 and 1408 lanes,
            timed at 22, 704 and 1408 lanes too. The three adders g1_add,
            g1_add_sel and g1_add_sel_proj (a lane over six threads) also at
            704, 1408 and 22528 lanes, and timed at 22, 704 and 1408 lanes
            too; g1_add_sel_proj at every width with all lanes valid, half,
            one in 16 and none besides the planted invalid lanes, and timed
            at half and one in 16 valid. Registers, spills and shared memory
            of fq_mul, fq_apply, g1_double and the adders from the build
            log. fq_mul_canon,
            fq_mul_chain12 and fr_mul each against its plain version, equal
            bit for bit (raw limbs, no normalize), at 2^16 elements and at
            1, 129 and 1001, with 0, 1, p - 1, p, 2p - 1 and the largest
            operand (2q - 1, 4r - 1) planted in every pairing; fq_mul_canon
            (on fq_mul_ptx) also timed at 1, 129 and 1001, its registers
            from the build log
  msm       msm_host at 2^12 points in both MSM modes (batch-affine and
            projective) and the device entry msm(scalars, points, c=4)
            against the host Pippenger oracle; g1.to_affine, the path of
            fq_mul, counts set to 0 before and read after; msm_batch_host with k = 4
            over the first 32768 SRS powers in both modes (the four points
            equal msm_fast_host's one by one and are equal between the
            modes; seconds and launches of the batch and of four single
            MSMs); NTT round trip and one coset NTT at 2^17 against host
            evaluation
  matntt    ntt_lf, intt_lf, coset_ntt_lf, coset_intt_lf at 2^14, 2^15 and
            2^17 through MatNTT and through the butterfly network: equal
            after normalize, and equal to host evaluation at a few indices;
            seconds of both paths, first and second call apart; one 2^17
            transform with FUSED_REDUCE off (the chain of carry kernels);
            ntt_batch_lf16 at (4, 2^15)
  micro     keys, proof and verification of micro.aleo/bump
  transfer  the main path at full size: synthesize_keys, prove_execution and
            verify_execution of token.aleo/transfer (examples/simple_token),
            with the kernels' launch counts set to 0 just before and read
            just after; then the same proof again through the projective MSM
            (MSM_AFFINE_MODE "0"), counts set to 0 before and read after: it
            must verify, give the same bytes, and launch the g1 kernels and
            none of the batch-affine ones
  credits   credits.aleo as the dev server, the worker and the CLI prove it,
            at its three shapes: transfer_private (n = 8192, m = 32768), join
            (4096, 32768: m/n = 8) and transfer_public (2048, 8192), keys
            synthesized over the shared SRS, one proof each seeded as the
            transfer's and verified, counts set to 0 before and read after;
            join again through the projective MSM (counts set to 0 before and
            read after), verified, and the join proof rejected under a public
            input changed by 1; every verifying key, public input and proof
            (join in both modes) equal to the JAX package's; per function the
            seconds of its keys, proof and verification and its (n, m)
  batch     the batch prover at full size: k = 4 token.aleo/transfer
            transitions with four different amounts (n = 8192, m = 32768)
            through prove_batch with one seeded rng, in the batch-affine mode
            and again in the projective mode, counts set to 0 before each
            and read after: every proof verifies with its own public inputs,
            proof 0 is rejected under proof 1's, the two modes give equal
            bytes proof by proof; seconds for the batch and per proof, stage
            timers, launches of every kernel, the number of batched
            transforms by path, peak device memory; then k = 8 once in the
            mode that was faster at k = 4 (its first and last proof are
            verified)
  fixed_base  the fixed-base MSM (msm/fixed_base.py), off by default, at
            full size: (a) the table of the first 32768 SRS powers at
            c = 13 (655,360 rows; 1280 sampled rows against host doubling
            chains; its launches, seconds and bytes), and batch_inv_lf and
            fq_mul at its 655,360 lanes against the plain product; (b)
            msm_fixed_host and msm_fixed_batch_host (k = 4) at 2^12 and 2^15
            points against msm_fast_host in both MSM modes, and one member
            each against the host Pippenger; (c) F1's commit group, four
            polynomials of 32767 coefficients at shift 3 through
            kzg.commit_many_lf with FIXED_BASE_MODE "1" against "0" and one
            member against the host Pippenger (`f1_shape_agrees`); (d) a
            transfer proof with the mode "auto", tables built and then
            cached, beside the default proof: equal bytes, verified; the
            host oracles run in worker processes meanwhile
  tools     the two stand-alone scripts that run the product kernels,
            tools/torch_proto_mul.py and tools/torch_microbench_fr_mul.py,
            at their default 2^16 elements, counts set to 0 before and read
            after
  limbs_last  the limbs-last device API at the sizes of a transfer proof
            (m = |K| = 32768, n = |H| = 8192), over the same SRS: FR_RING
            and FQ_RING mul, add, sub, neg, batch_inv and inv at 2^16 lanes
            against host integers on 64 sampled lanes (zero lanes planted for
            inv) and every lane against the JAX package's (by digest), every
            output lane canonical, FR_RING.mul timed beside
            fr_lf.mul; coset_ntt / coset_intt at 2^16 (round trip, one
            evaluation against host Horner); eval_coeffs and
            divide_by_linear_via_domain at m coefficients (q(x)(x - z) + y =
            p(x) at a random x); poly_mul of two 16384-coefficient
            polynomials and divide_by_vanishing of 40960 coefficients by n,
            each checked at a random point; kzg.commit and commit_host of m
            coefficients equal to commit_lf; open_at and batch_open_at over
            4 polynomials of n coefficients verify, and fail on a tampered
            y; every output above (values by digest, points as bytes) equal
            to the JAX package's, the inputs' digests checked first; a
            UniversalSrsBlob of 4096 powers through bytes and to_srs() with no
            device lands on the card with the SRS's powers; the kernels'
            launch counts of the phase
  record_scan  a wallet's record scan (upstream:rust/src/api/blocking.rs:
            261-318, encryptor.rs:47,66): Poseidon hash_batch at rates 2, 4
            and 8 over 16384 rows of 4 inputs and permute at each rate, 32
            rows against the host oracle; shared_secrets with a full-width
            view scalar over 16384 ephemeral points (running sums of two
            random points) with one point off the curve planted among them,
            built so that the ladder's second step meets a zero denominator
            (F5; a 250-bit view scalar with its top two bits set), 16 sampled
            lanes and the planted one against the host ladder, the 16383
            on-curve lanes against the JAX package's ladder; the ladder's
            steps, its batch_inv readbacks, and the CUDA launches of one
            ladder step from torch.profiler
  mesh      parallel/mesh.py in a world of one under NCCL, mesh (1, 1) (one
            card: the butterfly runs no step and the all-to-all moves one
            block; no exchange between cards is verified): sharded_msm over
            32768 SRS powers in both MSM modes against msm.msm (affine
            points), sharded_ntt at 2^17 = 256 x 512 with MatNTT local
            transforms against ntt.ntt (limbs after normalize), prove_batch
            of four transfers over the dp axis against the same seeded
            batch without a mesh (equal bytes; proof 0 verified),
            graft_entry.entry()'s step against the host (h and the MSM),
            graft_entry.dryrun_multichip(1) (its own host checks); the
            launches of each sharded call (counts set to 0 before it), the
            seconds of a first and a second call of each, in turns with the
            unsharded one
  sdk       the host SDK: a Ledger(verify_proofs=True), ProgramManager
            proving token.aleo/transfer (its keys synthesized by the
            pipeline over the SRS cached by the srs step), accepted by the
            ledger, a tampered copy refused; a wallet scan through
            LocalAPIClient.get_unspent_records over 64 genesis ciphertexts,
            one device ladder, equal to the per-record host scan
  serve     the user's ways in, proving credits.aleo transitions at full
            size over the same SRS into a Ledger(verify_proofs=True) seeded
            with 9 genesis records (fewer than BATCH_ECDH_MIN: every scan
            takes the host ECDH), which verifies each proof on broadcast:
            (a) the dev server (DevServer, prove=True, on 127.0.0.1) through
            DevelopmentClient: a private transfer with the request's key, one
            with the server's key ciphertext and a password, a join with a
            fee (three distinct serial numbers and a fee transition) and a
            split of a record holding more than the split amount and less
            than twice it; HttpAPIClient on the same server reads the height
            and each transaction, equal to the ledger's, and every block of
            the ledger by its hash, equal to it read by its height
            ("blocks_by_hash": their count, with the reads' seconds), an
            unknown hash answered 400; GET /health; (b) the proving worker
            (ProvingWorker, prove=True): ALEO_TRANSFER
            private_to_public and ALEO_EXECUTE_PROGRAM_ON_CHAIN
            credits.aleo/transfer_public, fee 0, the public balances read
            back; (c) the CLI (`cli.main`, its devnet file under a temporary
            directory): devnet mint, transfer --prove --device cuda, the
            proof verified against the verifying key the devnet file holds,
            then `devnet status` in a process with CUDA_VISIBLE_DEVICES=""
            (height 2: the file is bound to no device). Seconds and the
            (n, m) of each proof per request; the kernels' launches over the
            phase (counts set to 0 at its start)
  bench     the JAX package's bench entry point at its own sizes, through
            aleo_tpu_torch/bench.py's section functions, every size held
            against the host before it is timed (the host's side in worker
            processes meanwhile): fmat_reduce against its plain version at
            (76, 2^22), the widest stage of these transforms, and its device
            time there; the MSMs over the bench's 64 points tiled (so about
            one lane in 32 of a round meets P + P or P + (-P)), each equal to
            the tiled oracle (per point class, the scalars summed in int64,
            then a host MSM of the 64 points): msm_fast_host at 2^16 in both
            MSM modes, msm_batch_host at k = 4 x 2^16 (equal to four
            msm_fast_host calls too), one chunk of 2^22 points in both modes,
            with the rounds each ran; then bench_msm and bench_msm_2e24 timed,
            their points against the oracle (all four chunks and their sum);
            ntt_lf and coset_ntt_lf at 2^20 and 2^22 on random data: MatNTT
            equal to the butterfly after normalize, both round trips, index 0
            equal to the host sum, two indices (one of the coset) equal to
            host Horner evaluations; bench_ntt timed; a batch of 16 transfers
            (the bench's inputs) through prove_batch, proofs 0 and 15
            verified, proof 0 rejected under proof 1's public inputs, its
            peak device memory; each section's seconds, the bench's detail
            and the kernels' launches over the phase
  scan_widths  opt-in (only when named; a partial run): the record scan's
            two ECDH paths at 64, 256, 1024 and 4096 ciphertexts, one device
            ladder (shared_secrets, what api_client._batch_shared calls from
            BATCH_ECDH_MIN on) against one host edwards.mul a record (what
            the scan does below it), on the same points and view scalar,
            every lane equal; the rest of a record's probe is the same on
            both paths, so where these times cross is where the batch pays

The JAX package's own outputs. tests/torch_vectors/jax_reference.json
(written on the CPU by scripts/torch_make_jax_vectors.py, which runs the JAX
package on this script's inputs and sizes) is read at the start: a missing
file, or an entry whose inputs differ from this script's constants, fails
the run. Held against it, byte for byte: the SRS's G1 powers (srs step), the
transfer's verifying key, public inputs and proof in both MSM modes
(transfer), the three credits.aleo functions' keys, public inputs and proofs
(credits; join in both modes), the fixed-base `auto` proof (fixed_base), the
four proofs of the batch in both modes (batch), the MatNTT
transforms at 2^20 and 2^22, forward and coset, as digests of their
canonical values and eight sampled values, and the 2^16 MSM (bench),
Poseidon's hash_batch over all 16384 rows at each rate and the ECDH over the
16383 on-curve points (record_scan; the JAX ladder gets no off-curve point,
so F5, which it keeps, does not show), and every output of the limbs-last
API (limbs_last). Each of these phases' lines carries "jax_vectors": {entry:
true}. Not held against it: the serve phase (the JAX server and worker keep
F3), the k = 8 and k = 16 batches, the 2^24 MSM, mesh and sdk.

It fails (non-zero exit, no result line) without CUDA, if the build fails,
if the vector file is missing or disagrees, or if any phase fails. The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds. `bound_ms` is the larger of bytes / 3.35 TB/s (each input read once,
each output written once) and operations / 16.75e12 per second, where one
operation is one 32-bit integer multiply-add instruction (a 32x32->64
multiply-accumulate is two) and the rate is half the card's published
float32 rate of 67 TFLOP/s = 33.5e12 multiply-adds per second, since an SM
has half as many int32 lanes as float32 lanes.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import multiprocessing
import os
import copy
import random
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device: this script runs on the GPU only\n")
    sys.exit(1)

from aleo_tpu_torch import _build, bench, cli, config, graft_entry, params
from aleo_tpu_torch.curves import edwards_device as ed
from aleo_tpu_torch.curves import g1 as g1mod
from aleo_tpu_torch.curves import g1_affine as ga
from aleo_tpu_torch.curves import g1_fused as gf
from aleo_tpu_torch.fields import fmat
from aleo_tpu_torch.fields import fmat_kernels as fk
from aleo_tpu_torch.fields import fr_lf as lf
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.fields import proto_mul as pm
from aleo_tpu_torch.fields.modring import FQ_RING, FR_RING
from aleo_tpu_torch.hash import poseidon
from aleo_tpu_torch.msm import fixed_base
from aleo_tpu_torch.msm import msm as msm_mod
from aleo_tpu_torch.ntt import matntt
from aleo_tpu_torch.ntt import ntt as dntt
from aleo_tpu_torch.parallel import mesh as pmesh
from aleo_tpu_torch.pcs import kzg
from aleo_tpu_torch.pcs import poly_device as pd
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.program.examples import load_example, load_program
from aleo_tpu_torch.program.interpreter import Registry
from aleo_tpu_torch.program.parser import parse_program
from aleo_tpu_torch.program.values import Record, Value
from aleo_tpu_torch.reference import edwards
from aleo_tpu_torch.reference import polynomial as rpoly
from aleo_tpu_torch.reference import poseidon as ref_poseidon
from aleo_tpu_torch.reference.curve import G1
from aleo_tpu_torch.reference.field import FR, fr_root_of_unity
from aleo_tpu_torch.reference.msm import msm_pippenger_jac
from aleo_tpu_torch.snark import batch as batch_mod
from aleo_tpu_torch.snark import pipeline
from aleo_tpu_torch.snark.serialize import point_to_bytes, proof_from_bytes, proof_to_bytes
from aleo_tpu_torch.snark.snarkvm_bytes import UniversalSrsBlob
from aleo_tpu_torch.sdk import api_client, encryptor, wire
from aleo_tpu_torch.sdk.account import PrivateKey
from aleo_tpu_torch.sdk.api_client import ApiError, HttpAPIClient, LocalAPIClient
from aleo_tpu_torch.sdk.credits import registry_with_credits
from aleo_tpu_torch.sdk.dev_server import DevServer
from aleo_tpu_torch.sdk.development_client import DevelopmentClient
from aleo_tpu_torch.sdk.ledger import Ledger
from aleo_tpu_torch.sdk.program_manager import ProgramManager
from aleo_tpu_torch.sdk.worker import ProvingWorker
from aleo_tpu_torch.snark.verifier import verify
from aleo_tpu_torch.utils import profiling as prof

DEV = torch.device("cuda")
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "torch_vectors", "jax_reference.json")
Q, R = params.Q, params.R
L = params.FQ_LIMBS
SEED = 20240229

HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 16.75e12
MADS_PER_PRODUCT = 2 * 2 * 12 * 12      # two 12x12-word passes, 2 instructions each

# lane grid of a 32768-point MSM at auto_c = 12: 22 windows x 2048 buckets
# plus one eighth of spare lanes (the projective pipeline has no spares)
M_GRID = 22 * 2048 * 9 // 8             # 50688
M_PROJ = 22 * 2048                      # 45056
M_WINDOWS = 22                          # the end of the bucket reduction
# more widths of add_lf in a 32768-point projective MSM (c = 12): the scan
# steps of 704 and 1408 lanes, the first level of the window trees (22528)
M_SPREAD_WIDTHS = (704, 1408, 22528)
M_FERMAT = ga.FERMAT_W                  # 128
M_ROOTS = -(-M_GRID // ga.INV_TILE)     # 50 tile products at the grid's root
M_TWO_LEVELS = 4 * 22 * 2048            # 180224: msm_batch_host's grid at k = 4
# fq_apply's other widths: ragged tiles, and msm_batch_host's grid
M_APPLY_WIDTHS = (1, 127, 129, 1001, M_TWO_LEVELS)
# fq_mul's widths: to_affine's 2 points, ragged warps and blocks, the grid,
# msm_batch_host's grid; the timed ones; operand pairs at 2p and 2p - 1
M_MUL_WIDTHS = (1, 2, 31, 33, 127, 129, 1001, M_GRID, M_TWO_LEVELS)
M_MUL_TIMED = (2, 128, M_GRID, M_TWO_LEVELS)
MUL_EDGE = [(2 * Q, 2 * Q), (2 * Q, 2 * Q - 1), (2 * Q - 1, 2 * Q), (2 * Q - 1, 2 * Q - 1),
            (0, 2 * Q), (2 * Q, 1), (Q, 2 * Q)]
# g1_double's widths beyond those of every g1 kernel: ragged warps, the
# scan steps of the bucket reduction; and where it is timed
M_DOUBLE_WIDTHS = (31, 33, 704, 1408)
M_DOUBLE_TIMED = (M_WINDOWS, 704, 1408)
# fq_fermat's multiply-adds a lane (csrc/fq_inv.cuh): a batch's matrix times f, g (4
# products a limb) and d, e with their multiples of p (6), 32x32->64 each
SAFEGCD_MADS = ga.SAFEGCD_BATCHES * 2 * (4 + 6) * ga.S30_LIMBS

# one MatNTT stage of a 2^17 transform: 76 raw columns of 131072 lanes
M_STAGE = 1 << 17
REDUCE_MADS = 38 * 39 // 2 + 38 * 38    # the N' band (triangular) and the p band
MADS_PER_FR_PRODUCT = 2 * 2 * 8 * 8      # the same two passes over 8 words
M_PROTO = 1 << 16                       # the tools' default element count
MSM_BATCH_N, MSM_BATCH_K = 32768, 4     # a transfer proof's largest commits
BATCH_K, BATCH_K_ONCE = 4, 8
# phase fixed_base: the table over the first 32768 SRS powers at c = 13,
# MSMs at 2^12 and 2^15 points (k = 4 in a batch), F1's commit group
FB_N, FB_SIZES, FB_K = 1 << 15, (1 << 12, 1 << 15), 4
FB_ROW_POINTS = 64                      # x 20 windows = 1280 rows held against the host
F1_N, F1_SHIFT, F1_K = 32767, 3, 4
FB_ORACLE_C = 12                        # the host Pippenger's window at these sizes
# phase limbs_last: the ring ops at 2^16 lanes, checked on SAMPLE lanes; the
# polynomial sizes of a transfer proof (|K| = m, |H| = n); 4 polynomials
# opened at once; a universal SRS blob of 4096 powers
SAMPLE = 64
LL_LANES, LL_M, LL_N = 1 << 16, 32768, 8192
LL_MUL, LL_VANISH, LL_OPEN, LL_SRS_POWERS = 16384, 40960, 4, 4096
# phase record_scan: B rows of 4 record fields hashed, 32 checked; the ECDH
# over 16384 ephemeral points, 16 checked against the host, every on-curve
# lane against the JAX package's ladder
RS_ROWS, RS_INPUTS, RS_HASH_CHECKED = 16384, 4, 32
RS_POINTS, RS_ECDH_CHECKED, RS_ECDH_LANES = 16384, 16, 16383
# phase mesh: the sharded MSM over a transfer proof's m points, the sharded
# NTT at 2^17 as 256 x 512; phase sdk: the genesis records of the wallet scan
MESH_POINTS, MESH_NTT = 32768, (256, 512)
SDK_RECORDS = 64
# phase serve: alice's genesis records (carol holds one more), the join's fee,
# the split's amount (carol's record holds 1M: more than it, less than twice)
SERVE_RECORDS, SERVE_FEE, SERVE_SPLIT = 8, 10_000, 600_000
# opt-in phase scan_widths: the widths of the scan's ECDH
SCAN_WIDTHS = (64, 256, 1024, 4096)
# phase bench: the sizes of aleo_tpu_torch/bench.py's sections (the JAX
# bench's): the MSM at 2^16 and a batch of 4 over its table, 4 chunks of 2^22
# points; the transforms checked on random data at 2^20 and 2^22, K1 at the
# widest stage they run; a batch of 16 transfers
BENCH_MSM_N, BENCH_MSM_K = bench.MSM_N, 4
BENCH_CHUNK, BENCH_CHUNKS = 1 << 22, 4
BENCH_NTT_LOGNS = (20, 22)
BENCH_STAGE = 1 << 22
BENCH_PROOFS = 16
FR_MONT_INV = pow(1 << (16 * params.FR_LIMBS), -1, R)   # 2^-256 mod r
SRS_SEED, SRS_DEGREE = b"aleo-tpu-srs", 32769
TRANSFER_AMOUNT, RNG_NONCE = 120, 11
SENDER, RECEIVER = 123456789, 987654321
# phase credits: three credits.aleo functions, one of each (n, m) that the
# dev server, the worker and the CLI prove, owned and called by the
# transfer's sender; records as [microcredits, nonce] (the vector file's
# credits entry)
CREDITS = {"program": "credits.aleo", "caller": SENDER, "rng_nonce": RNG_NONCE,
           "rng_seed": SEED,
           "functions": {
               "transfer_private": {"n": 8192, "m": 32768, "records": [[1_000_000, 7]],
                                    "receiver": RECEIVER, "amount": 250_000},
               "join": {"n": 4096, "m": 32768, "records": [[300_000, 7], [200_000, 8]]},
               "transfer_public": {"n": 2048, "m": 8192,
                                   "receiver": RECEIVER, "amount": 50_000}}}
NTT_SAMPLES = 8
OPT_IN_PHASES = {"scan_widths"}
PHASES = {"kernels", "msm", "matntt", "micro", "transfer", "credits", "batch", "fixed_base",
          "tools", "limbs_last", "record_scan", "mesh", "sdk", "serve", "bench"}

_G1, _FMAT = "aleo_tpu_torch/csrc/g1_affine.cu", "aleo_tpu_torch/csrc/fmat.cu"
_G1F = "aleo_tpu_torch/csrc/g1_fused.cu"
_PM = "aleo_tpu_torch/csrc/proto_mul.cu"
KERNELS = {         # name -> (source, the TPU kernel it replaces)
    "fq_prepare": (_G1, "aleo_tpu/curves/g1_affine.py:240"),
    "fq_mul": (_G1, "aleo_tpu/curves/g1_affine.py:300"),
    "fq_inv_up": (_G1, "aleo_tpu/curves/g1_affine.py:300"),
    "fq_inv_down": (_G1, "aleo_tpu/curves/g1_affine.py:300"),
    "fq_fermat": (_G1, "aleo_tpu/curves/g1_affine.py:319"),
    "fq_apply": (_G1, "aleo_tpu/curves/g1_affine.py:273"),
    "fmat_reduce": (_FMAT, "aleo_tpu/fields/fmat_pallas.py:114"),
    "fmat_carry2d": (_FMAT, "aleo_tpu/fields/fmat_pallas.py:53"),
    "fmat_carry3d": (_FMAT, "aleo_tpu/fields/fmat_pallas.py:69"),
    "g1_double": (_G1F, "aleo_tpu/curves/g1_fused.py:350"),
    "g1_add": (_G1F, "aleo_tpu/curves/g1_fused.py:210"),
    "g1_add_sel": (_G1F, "aleo_tpu/curves/g1_fused.py:243"),
    "g1_add_sel_proj": (_G1F, "aleo_tpu/curves/g1_fused.py:302"),
    "g1_normalize": (_G1F, "aleo_tpu/curves/g1_fused.py:376"),
    "fq_mul_canon": (_PM, "tools/proto_pallas_mul.py:122"),
    "fq_mul_chain12": (_PM, "tools/proto_pallas_mul.py:153"),
    "fr_mul": (_PM, "tools/microbench_fr_mul.py:86"),
}
AFFINE_KERNELS = ("fq_prepare", "fq_inv_up", "fq_fermat", "fq_inv_down", "fq_apply")
PROJECTIVE_KERNELS = ("g1_double", "g1_add", "g1_add_sel", "g1_add_sel_proj")
PROTO_KERNELS = ("fq_mul_canon", "fq_mul_chain12", "fr_mul")
# the kernels of the mesh phase's paths (both MSM modes, MatNTT) and of the
# sdk and serve phases' (batch-affine proofs and their keys)
MESH_KERNELS = AFFINE_KERNELS + PROJECTIVE_KERNELS + ("g1_normalize", "fmat_reduce")
SDK_KERNELS = AFFINE_KERNELS + ("g1_normalize", "fmat_reduce")

MICRO = """
program micro.aleo;

function bump:
    input r0 as u64.private;
    add r0 1u64 into r1;
    output r1 as u64.private;
"""


def say(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def fq_tensor(ints):
    return limbs.to_tensor(limbs.ints_to_limbs(ints, L).T, DEV)


def norm(t):
    return lk.normalize(lk.get_fq(), t)


def same(a, b):
    """Exact equality of two Fq limb tensors after normalize -> max |diff|."""
    return int((norm(a).to(torch.int64) - norm(b).to(torch.int64)).abs().max().item())


def kernel_ms(launch, sets, reps=10):
    """Device time of one kernel launch, in ms. `launch(args)` is called once
    for each argument tuple of `sets` while a CUDA graph is captured, and the
    graph's replays are timed with events: the wrappers' host time is not in
    it. The sets are distinct buffers of more than the 50 MB L2 cache in
    all, so each launch finds its inputs in device memory as a round of the
    MSM does."""
    for args in sets:
        launch(args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in sets:
            launch(args)
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * len(sets))


def reset_launches():
    ga.reset_launches()
    fk.reset_launches()
    gf.reset_launches()
    pm.reset_launches()


def all_launches():
    return {**ga.LAUNCHES, **fk.LAUNCHES, **gf.LAUNCHES, **pm.LAUNCHES}


def copies(args, n):
    """n argument tuples: the given one and n - 1 clones of it."""
    return [args] + [tuple(t.clone() for t in args) for _ in range(n - 1)]


def cuda_ms(fn, reps):
    """Time of one call in ms, host side included (events around a loop)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def int_bytes(values, width: int = 32) -> bytes:
    """Canonical integers as `width` bytes little-endian each, in order."""
    return b"".join(int(v).to_bytes(width, "little") for v in values)


def fr_digest(t):
    """sha256 of an (16, n) limbs-first Fr tensor's values as canonical
    integers, 32 bytes little-endian each, in index order: out of Montgomery
    form and normalized on the card, then the 16-bit limbs' bytes (numpy,
    no Python integers)."""
    v = lf.normalize(lf.from_mont(t)).cpu().numpy()
    return sha256(v.T.astype("<u2").tobytes())


# the JAX package's outputs (tests/torch_vectors/jax_reference.json), read by
# main before any phase runs
JAX = {}


def load_vectors():
    """The vector file's entries -> dict. Fails when the file is missing, an
    entry is missing, or an entry's inputs differ from this script's
    constants."""
    with open(VECTORS) as f:
        entries = json.load(f)["entries"]
    want = {
        "srs": {"seed": SRS_SEED.decode(), "max_degree": SRS_DEGREE},
        "transfer": {"example": "simple_token", "program": "token.aleo", "function": "transfer",
                     "sender": SENDER, "receiver": RECEIVER, "record_amount": 500,
                     "record_nonce": 7, "amount": TRANSFER_AMOUNT, "rng_nonce": RNG_NONCE,
                     "rng_seed": SEED},
        "msm": {"n": BENCH_MSM_N, "scalar_seed": 0xBE7C, "tile": bench.TILE},
    }
    want["batch"] = {**want["transfer"], "amount": None,
                     "amounts": [100 + i for i in range(BATCH_K)]}
    want["credits"] = CREDITS
    for name in ("srs", "transfer", "batch", "ntt", "msm", "poseidon", "credits", "ecdh",
                 "limbs_last"):
        assert name in entries, f"{VECTORS}: no entry {name!r}"
    for name, inputs in want.items():
        assert entries[name]["inputs"] == inputs, \
            f"{VECTORS}: the inputs of {name!r} differ from this script's"
    ntt = entries["ntt"]
    assert sorted(k for k in ntt if k != "seconds") == \
        sorted(str(1 << logn) for logn in BENCH_NTT_LOGNS), sorted(ntt)
    for logn in BENCH_NTT_LOGNS:
        got = {k: v for k, v in ntt[str(1 << logn)]["inputs"].items() if k != "input_sha256"}
        assert got == {"logn": logn, "seed": SEED + logn, "shift": params.FR_GENERATOR}, got
    got = {k: v for k, v in entries["poseidon"]["inputs"].items() if k != "rows_sha256"}
    assert got == {"seed": SEED + 11, "rows": RS_ROWS, "inputs_per_row": RS_INPUTS,
                   "rates": [2, 4, 8]}, got
    # the record scan's ECDH: the planted lane and the inputs' digest are
    # held against the phase's draws
    got = {k: v for k, v in entries["ecdh"]["inputs"].items()
           if k not in ("planted", "input_sha256")}
    assert got == {"seed": SEED + 11, "points": RS_POINTS, "lanes": RS_ECDH_LANES}, got
    got = {k: v for k, v in entries["limbs_last"]["inputs"].items() if k != "input_sha256"}
    assert got == {"seed": SEED + 10, "lanes": LL_LANES, "sample": SAMPLE, "m": LL_M,
                   "n": LL_N, "mul": LL_MUL, "vanish": LL_VANISH, "open": LL_OPEN}, got
    return entries


def held(name, ok, what):
    """Fails the run unless `ok`: `what` of the port differs from entry
    `name` of the JAX package's outputs."""
    assert ok, f"{what} differs from the JAX package's ({VECTORS}, entry {name!r})"


# ---------------------------------------------------------------------------


def phase_device():
    t0 = time.time()
    line = smi_line()
    print(line, flush=True)
    _build.library()
    ptxas = [ln for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    say({"phase": "device", "card": line, "torch": torch.__version__,
         "cuda": torch.version.cuda, "ptxas": ptxas, "seconds": round(time.time() - t0, 3)})
    return line


def _grid_inputs(rng, m):
    """Random lazy (< 2p) accumulator and addend lanes with the rare cases
    planted: tangent (equal points, also with the +p representative),
    cancellation (P == -acc, by value and by sign), identities on either
    side, the (0, 0) sentinel, invalid lanes; a kind every 97 lanes, or
    closer where m is small, so that every case code occurs from 8 lanes on."""
    x1 = [rng.randrange(2 * Q) for _ in range(m)]
    y1 = [rng.randrange(1, 2 * Q) for _ in range(m)]
    x2 = [rng.randrange(2 * Q) for _ in range(m)]
    y2 = [rng.randrange(1, 2 * Q) for _ in range(m)]
    inf1 = [0] * m
    inf2 = [0] * m
    sign = [rng.randrange(2) for _ in range(m)]
    valid = [1] * m
    period = max(1, min(97, m // 8))
    for k in range(0, m, period):
        kind = (k // period) % 8
        a, b = x1[k] % Q, y1[k] % Q or 1
        x1[k], y1[k] = a, b
        if kind == 0:      # tangent, same representative
            x2[k], y2[k], sign[k] = a, b, 0
        elif kind == 1:    # tangent by sign: the differences come out as p
            x2[k], y2[k], sign[k] = a + Q, Q - b, 1
        elif kind == 2:    # P == -acc by value
            x2[k], y2[k], sign[k] = a, Q - b, 0
        elif kind == 3:    # P == -acc by sign, lazy x
            x2[k], y2[k], sign[k] = a + Q, b, 1
        elif kind == 4:    # acc identity
            inf1[k], x1[k], y1[k] = 1, 0, 0
        elif kind == 5:    # addend identity: the (0, 0) sentinel
            inf2[k], x2[k], y2[k] = 1, 0, 0
        elif kind == 6:    # both identity
            inf1[k], inf2[k], x1[k], y1[k], x2[k], y2[k] = 1, 1, 0, 0, 0, 0
        else:              # invalid lane
            valid[k] = 0
    flag = lambda v: torch.tensor([v], dtype=torch.int32, device=DEV)
    return (fq_tensor(x1), fq_tensor(y1), flag(inf1), fq_tensor(x2), fq_tensor(y2),
            flag(inf2), flag(sign), flag(valid))


def _apply_check(rng, m):
    """fq_apply against its plain version at m lanes, on the prepared
    numerators and case codes of _grid_inputs and the true inverses of its
    denominators -> (max_abs_err after normalize, stored limbs and flags
    equal). Every case code is planted from 8 lanes on; the lanes of
    CASE_KEEP must return the accumulator bit for bit."""
    x1, y1, inf1, x2, y2, inf2, sign, valid = _grid_inputs(rng, m)
    dp, nump, casep = ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    if m >= 8:
        assert all(bool((casep == k).any()) for k in range(4)), f"a case has no lane at {m}"
    inv = ga._fermat_plain(dp)
    got = ga.fq_apply(x1, y1, inf1, x2, y2, sign, casep, nump, inv)
    want = ga._apply_plain(x1, y1, inf1, x2, y2, sign, casep, nump, inv)
    torch.cuda.synchronize()
    keep = (casep == ga.CASE_KEEP)[0]
    for g, a in zip(got, (x1, y1)):
        assert torch.equal(g[:, keep], a[:, keep]), f"fq_apply changed a kept lane at {m}"
    err = max(same(got[0], want[0]), same(got[1], want[1]),
              int((got[2] - want[2]).abs().max().item()))
    return err, all(torch.equal(g, w) for g, w in zip(got, want))


def _mul_operands(rng, w):
    """Two (L, w) operands <= 2p: random, with MUL_EDGE planted at both ends
    (the first lanes a thread takes and the last)."""
    a = [rng.randrange(2 * Q + 1) for _ in range(w)]
    b = [rng.randrange(2 * Q + 1) for _ in range(w)]
    for k, (u, v) in enumerate(MUL_EDGE[:w]):
        a[k], b[k] = u, v
        a[w - 1 - k], b[w - 1 - k] = u, v
    return fq_tensor(a), fq_tensor(b)


def _mul_kernel(res, rng):
    """fq_mul, the elementwise product of to_affine, against its plain
    version at M_MUL_WIDTHS (exact after normalize; the stored limbs too),
    and its times at M_MUL_TIMED; registers from the build log."""
    err, raw, ops = 0, True, {}
    for w in M_MUL_WIDTHS:
        a, b = ops[w] = _mul_operands(rng, w)
        got, want = ga.fq_mul(a, b), ga._mul_plain(a, b)
        err, raw = max(err, same(got, want)), raw and torch.equal(got, want)
    torch.cuda.synchronize()
    a, b = ops[M_GRID]
    res["fq_mul"] = {
        "max_abs_err": err, "lanes": M_GRID, "widths": list(M_MUL_WIDTHS), "raw_limbs_equal": raw,
        "ms": kernel_ms(lambda t: ga.fq_mul(*t), copies((a, b), 8)),
        "plain_ms": cuda_ms(lambda: ga._mul_plain(a, b), 5),
        "bytes": 3 * 4 * L * M_GRID, "mads": MADS_PER_PRODUCT * M_GRID,
        "ptxas": _build.ptxas_info().get("fq_mul_kernel", "not built in this process"),
    }
    for w in M_MUL_TIMED:
        if w != M_GRID:
            t = ops[w] if w in ops else _mul_operands(rng, w)
            res["fq_mul"][f"ms_{w}_lanes"] = kernel_ms(lambda t: ga.fq_mul(*t), copies(t, 4))


def _madd_plain(x1, y1, inf1, x2, y2, inf2, sign, valid):
    """madd from the plain versions alone (every lane inverted on its own)."""
    d, num, case = ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    return ga._apply_plain(x1, y1, inf1, x2, y2, sign, case, num, ga._fermat_plain(d))


RM = (1 << 384) % Q                     # Montgomery one
INV_EDGE = [1, 2, Q - 1, Q + 1, 2 * Q - 1, RM, RM + Q] + [
    1 << k for k in range((2 * Q).bit_length()) if 1 << k < 2 * Q]


def _inv_inputs(rng, w):
    """(L, w) lazy Montgomery values (< 2p, nonzero mod p), INV_EDGE planted
    at the front."""
    vals = [rng.randrange(1, 2 * Q) for _ in range(w)]
    vals = [v if v % Q else 1 for v in vals]
    vals[: len(INV_EDGE)] = INV_EDGE[:w]
    return fq_tensor(vals)


def _inversion_kernels(res, rng, dp, inv):
    """fq_inv_up, fq_fermat, fq_inv_down against their plain versions (exact
    after normalize) at the grid's width (the prepared denominators dp, with
    INV_EDGE planted), at 1, 129, 1001 and M_TWO_LEVELS lanes; fq_fermat also
    at the root widths 50 and 128; batch_inv_lf whole against host inverses,
    with its launches counted; and the three kernels' times."""
    m = dp.shape[1]
    main = dp.clone()
    main[:, : len(INV_EDGE)] = fq_tensor(INV_EDGE)
    err = {"fq_inv_up": 0, "fq_fermat": 0, "fq_inv_down": 0}
    raw = dict.fromkeys(err, True)      # equal before normalize too

    def hold(name, got, want):
        err[name] = max(err[name], same(got, want))
        raw[name] = raw[name] and torch.equal(got, want)

    calls = {}
    for w in (m, 1, 129, 1001, M_TWO_LEVELS):
        d = main if w == m else _inv_inputs(rng, w)
        want = ga._fermat_plain(d)                  # host inverses
        hold("fq_fermat", ga.fq_fermat(d), want)
        roots = ga._inv_up_plain(d)
        hold("fq_inv_up", ga.fq_inv_up(d), roots)
        rinv = ga._fermat_plain(roots)
        hold("fq_inv_down", ga.fq_inv_down(d, rinv), ga._inv_down_plain(d, rinv))
        before = dict(ga.LAUNCHES)
        binv = ga.batch_inv_lf(d)
        calls[w] = {k: ga.LAUNCHES[k] - before[k] for k in before if ga.LAUNCHES[k] > before[k]}
        assert same(binv, want) == 0, f"batch_inv_lf disagrees at width {w}"
        levels = 0 if w <= ga.FERMAT_W else 1 if w <= ga.FERMAT_W * ga.INV_TILE else 2
        assert calls[w] == {"fq_fermat": 1, **({"fq_inv_up": levels, "fq_inv_down": levels}
                                               if levels else {})}, (w, calls[w])
    roots = {}
    for w in (M_ROOTS, M_FERMAT):
        roots[w] = _inv_inputs(rng, w)
        hold("fq_fermat", ga.fq_fermat(roots[w]), ga._fermat_plain(roots[w]))
    torch.cuda.synchronize()

    nt = -(-m // ga.INV_TILE)
    rinv = ga._fermat_plain(ga._inv_up_plain(main))
    exp_products = (Q - 2).bit_length() - 1 + bin(Q - 2).count("1") - 1
    f128 = roots[M_FERMAT]
    res["fq_inv_up"] = {
        "max_abs_err": err["fq_inv_up"], "lanes": m, "tiles": nt,
        "ms": kernel_ms(lambda a: ga.fq_inv_up(*a), copies((main,), 12)),
        "plain_ms": cuda_ms(lambda: ga._inv_up_plain(main), 3),
        "bytes": 4 * L * (m + nt), "mads": MADS_PER_PRODUCT * (m - nt),
    }
    res["fq_inv_down"] = {
        "max_abs_err": err["fq_inv_down"], "lanes": m, "tiles": nt,
        "ms": kernel_ms(lambda a: ga.fq_inv_down(*a), copies((main, rinv), 12)),
        "plain_ms": cuda_ms(lambda: ga._inv_down_plain(main, rinv), 3),
        "bytes": 4 * L * (2 * m + nt), "mads": 3 * MADS_PER_PRODUCT * (m - nt),
    }
    res["fq_fermat"] = {
        "max_abs_err": err["fq_fermat"], "lanes": M_FERMAT,
        "ms": kernel_ms(lambda a: ga.fq_fermat(*a), copies((f128,), 2)),
        f"ms_{M_ROOTS}_lanes": kernel_ms(lambda a: ga.fq_fermat(*a), copies((roots[M_ROOTS],), 2)),
        "plain_ms": cuda_ms(lambda: ga._fermat_plain(f128), 3),
        "bytes": 2 * 4 * L * M_FERMAT, "mads": SAFEGCD_MADS * M_FERMAT,
        "safegcd_mads_per_lane": SAFEGCD_MADS,
        # the work of a Fermat ladder, the reference's algorithm for this function
        "ladder_bound_ms": exp_products * MADS_PER_PRODUCT * M_FERMAT / INT32_MADS_PER_S * 1e3,
    }
    d2 = _inv_inputs(rng, M_TWO_LEVELS)
    for name, eq in raw.items():
        res[name]["raw_limbs_equal"] = eq
    res["fq_inv_up"]["batch_inv_lf_launches"] = {str(w): c for w, c in calls.items()}
    res["fq_inv_up"][f"batch_inv_lf_ms_{M_TWO_LEVELS}"] = cuda_ms(lambda: ga.batch_inv_lf(d2), 5)


def phase_kernels():
    t0 = time.time()
    rng = random.Random(SEED)
    m = M_GRID
    x1, y1, inf1, x2, y2, inf2, sign, valid = _grid_inputs(rng, m)
    res = {}

    # fq_prepare
    d, num, case = ga.fq_prepare(x1, y1, inf1, x2, y2, inf2, sign, valid)
    dp, nump, casep = ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    torch.cuda.synchronize()
    err = max(same(d, dp), same(num, nump), int((case - casep).abs().max().item()))
    counts = [int((casep == k).sum().item()) for k in range(4)]
    assert min(counts) > 0, f"a case has no lane: {counts}"
    res["fq_prepare"] = {
        "max_abs_err": err, "lanes": m, "case_lanes": counts,
        "ms": kernel_ms(lambda a: ga.fq_prepare(*a),
                        copies((x1, y1, inf1, x2, y2, inf2, sign, valid), 4)),
        "plain_ms": cuda_ms(lambda: ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid), 3),
        "bytes": (6 * 4 * L + 5 * 4) * m, "mads": MADS_PER_PRODUCT * m,
    }

    _mul_kernel(res, rng)

    inv = ga._fermat_plain(dp)
    _inversion_kernels(res, rng, dp, inv)

    # fq_apply, fed the true inverses of the prepared denominators, at the
    # grid's width and at M_APPLY_WIDTHS
    ox, oy, oinf = ga.fq_apply(x1, y1, inf1, x2, y2, sign, casep, nump, inv)
    px, py, pinf = ga._apply_plain(x1, y1, inf1, x2, y2, sign, casep, nump, inv)
    torch.cuda.synchronize()
    err = max(same(ox, px), same(oy, py), int((oinf - pinf).abs().max().item()))
    raw = all(torch.equal(g, w) for g, w in zip((ox, oy, oinf), (px, py, pinf)))
    for w in M_APPLY_WIDTHS:
        e, r = _apply_check(rng, w)
        err, raw = max(err, e), raw and r
    res["fq_apply"] = {
        "max_abs_err": err, "lanes": m, "raw_limbs_equal": raw,
        "widths": [m, *M_APPLY_WIDTHS],
        "ms": kernel_ms(lambda a: ga.fq_apply(*a),
                        copies((x1, y1, inf1, x2, y2, sign, casep, nump, inv), 4)),
        "plain_ms": cuda_ms(lambda: ga._apply_plain(x1, y1, inf1, x2, y2, sign, casep, nump, inv), 3),
        "bytes": (8 * 4 * L + 4 * 4) * m, "mads": 3 * MADS_PER_PRODUCT * m,
    }

    # madd whole, against the plain versions and against the plain madd
    acc = ga.G1AF(x1, y1, inf1)
    got = ga.madd(acc, x2, y2, inf2, sign, valid)
    assert same(got.x, px) == 0 and same(got.y, py) == 0
    assert int((got.inf - pinf).abs().max().item()) == 0
    wx, wy, winf = _madd_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    assert same(got.x, wx) == 0 and same(got.y, wy) == 0
    madd_ms = cuda_ms(lambda: ga.madd(acc, x2, y2, inf2, sign, valid), 5)
    narrow = tuple(t[:, :128].contiguous() for t in (x1, y1, inf1, x2, y2, sign, casep, nump, inv))
    res["fq_apply"]["ms_128_lanes"] = kernel_ms(lambda a: ga.fq_apply(*a), copies(narrow, 4))
    res["fq_apply"]["ptxas"] = _build.ptxas_info().get("fq_apply_kernel",
                                                        "not built in this process")
    binv_ms = cuda_ms(lambda: ga.batch_inv_lf(dp), 5)
    torch.cuda.synchronize()

    products = _fmat_kernels(res)
    _g1_kernels(res)
    _proto_kernels(res)

    for name, r in res.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["mads"] / INT32_MADS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        assert r["max_abs_err"] == 0, f"{name} disagrees with its plain version"
    say({"phase": "kernels", "kernels": res, "madd_ms": madd_ms,
         "batch_inv_lf_ms": binv_ms, "library_products": products,
         "seconds": round(time.time() - t0, 3)})
    return res


G1_KINDS = ("P+P", "P+(-P) by value", "P+(-P) by sign", "identity+P", "P+identity",
            "identity+identity, z=0", "identity+identity, z=p", "sentinel addend",
            "invalid lane", "P+P, lazy representatives")


def _g1_inputs(rng, m):
    """Random lazy (<= 2p) accumulator and addend lanes with the lanes of
    G1_KINDS planted among them, each kind in turn. -> (x1, y1, z1, x2, y2,
    z2, sign, valid) tensors and the number of lanes of each kind."""
    one = (1 << 384) % Q
    c = {k: [rng.randrange(2 * Q) for _ in range(m)]
         for k in ("x1", "y1", "z1", "x2", "z2")}
    c["y2"] = [rng.randrange(1, 2 * Q) for _ in range(m)]
    sign = [rng.randrange(2) for _ in range(m)]
    valid = [1] * m
    counts = [0] * len(G1_KINDS)
    period = max(1, min(97, m // len(G1_KINDS)))
    for k in range(0, m, period):
        kind = (k // period) % len(G1_KINDS)
        counts[kind] += 1
        a, b = c["x1"][k] % Q, c["y1"][k] % Q or 1
        c["x1"][k], c["y1"][k], c["z1"][k] = a, b, one
        c["x2"][k], c["y2"][k], c["z2"][k], sign[k] = a, b, one, 0
        if kind == 1:
            c["y2"][k] = Q - b
        elif kind == 2:
            sign[k] = 1
        elif kind == 3:
            c["x1"][k], c["y1"][k], c["z1"][k] = 0, one, 0
        elif kind == 4:     # projective: z2 = 0; affine: the sentinel
            c["x2"][k], c["y2"][k], c["z2"][k] = 0, 0, 0
        elif kind == 5:
            c["x1"][k], c["y1"][k], c["z1"][k] = 0, one, 0
            c["x2"][k], c["y2"][k], c["z2"][k] = 0, one, 0
        elif kind == 6:
            c["x1"][k], c["y1"][k], c["z1"][k] = Q, one + Q, Q
            c["x2"][k], c["y2"][k], c["z2"][k] = Q, one, Q
        elif kind == 7:
            c["x2"][k], c["y2"][k], sign[k] = 0, 0, 1
        elif kind == 8:     # a masked lane holding the largest lazy value
            valid[k], c["y1"][k] = 0, 2 * Q
        elif kind == 9:
            c["x2"][k], c["y2"][k], c["z1"][k] = a + Q, b + Q, one + Q
    flag = lambda v: torch.tensor([v], dtype=torch.int32, device=DEV)
    t = {k: fq_tensor(v) for k, v in c.items()}
    return (t["x1"], t["y1"], t["z1"], t["x2"], t["y2"], t["z2"],
            flag(sign), flag(valid)), counts


def same3(got, want):
    return max(same(g, w) for g, w in zip(got, want))


def _valid_rows(rng, valid):
    """K9's valid rows at the width of `valid` (1, M): as planted, all
    valid, half, few (one lane in 16) and none, the last three drawn at
    random."""
    m = valid.shape[1]
    row = lambda p: torch.tensor([[int(rng.random() < p) for _ in range(m)]],
                                 dtype=torch.int32, device=DEV)
    return {"planted": valid, "all": torch.ones_like(valid), "half": row(0.5),
            "few": row(1 / 16), "none": torch.zeros_like(valid)}


def _g1_check(args, rng, spread_only=False):
    """Each g1 kernel against its plain version on one set of inputs ->
    {name: max_abs_err}; only the three adders (a lane over several threads)
    if spread_only. g1_add_sel_proj under each of _valid_rows' rows. Masked
    lanes must hold the accumulator bit for bit."""
    x1, y1, z1, x2, y2, z2, sign, valid = args
    acc, addend = gf.G1LF(x1, y1, z1), gf.G1LF(x2, y2, z2)
    err = {"g1_add": same3(gf.add_lf(acc, addend), gf._add_plain(x1, y1, z1, x2, y2, z2))}
    got = gf.add_sel_lf(acc, x2, y2, sign, valid)
    err["g1_add_sel"] = same3(got, gf._add_sel_plain(x1, y1, z1, x2, y2, sign, valid))
    masked = ((valid == 0) | (y2.amax(dim=0, keepdim=True) == 0))[0]
    for g, a in zip(got, acc):
        assert torch.equal(g[:, masked], a[:, masked]), "g1_add_sel changed a masked lane"
    err["g1_add_sel_proj"] = 0
    for vname, vrow in _valid_rows(rng, valid).items():
        got = gf.add_sel_proj_lf(acc, addend, sign, vrow)
        err["g1_add_sel_proj"] = max(err["g1_add_sel_proj"], same3(
            got, gf._add_sel_proj_plain(x1, y1, z1, x2, y2, z2, sign, vrow)))
        masked = (vrow == 0)[0]
        for g, a in zip(got, acc):
            assert torch.equal(g[:, masked], a[:, masked]), \
                f"g1_add_sel_proj changed a masked lane ({vname} valid)"
    if spread_only:
        torch.cuda.synchronize()
        return err
    err["g1_double"] = same3(gf.double_lf(acc), gf._double_plain(x1, y1, z1))
    got, want = gf.normalize_lf(acc), gf._normalize_plain(x1, y1, z1)
    err["g1_normalize"] = max(int_err(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    return err


def _g1_on_the_curve(rng):
    """The five functions on real curve points at 22 lanes, decoded and held
    against the host group law."""
    m = M_WINDOWS
    g = G1.generator()
    ps = [G1.mul(rng.randrange(1, R), g) for _ in range(m)]
    qs = [G1.mul(rng.randrange(1, R), g) for _ in range(m)]
    qs[0], qs[1], qs[2], ps[3] = ps[0], G1.neg(ps[1]), None, None
    ps[4], qs[4] = None, None
    sign = [i % 2 for i in range(m)]
    valid = [0 if i % 5 == 4 and i > 4 else 1 for i in range(m)]
    P, Qp = gf.encode_lf(ps, device=DEV), gf.encode_lf(qs, device=DEV)
    assert gf.decode_lf(gf.double_lf(P)) == [G1.double(p) for p in ps]
    assert gf.decode_lf(gf.add_lf(P, Qp)) == [G1.add(p, q) for p, q in zip(ps, qs)]
    want = [G1.add(p, G1.neg(q) if s else q) if v else p
            for p, q, s, v in zip(ps, qs, sign, valid)]
    flag = lambda v: torch.tensor(v, dtype=torch.int32, device=DEV)
    assert gf.decode_lf(gf.add_sel_proj_lf(P, Qp, flag(sign), flag(valid))) == want
    table = msm_mod.make_table(gf.to_points(Qp)).T.contiguous()     # (0, 0) for None
    assert gf.decode_lf(gf.add_sel_lf(P, table[:L], table[L:], flag(sign), flag(valid))) == want


def _g1_kernels(res):
    """g1_double, g1_add, g1_add_sel, g1_add_sel_proj, g1_normalize against
    their plain versions, and their times."""
    rng = random.Random(SEED + 11)
    m = M_PROJ
    args, counts = _g1_inputs(rng, m)
    assert min(counts) > 0, f"a planted kind has no lane: {counts}"
    err = _g1_check(args, rng)
    for w in (1, M_WINDOWS, 129, 1001):
        small, small_counts = _g1_inputs(rng, w)
        assert w < len(G1_KINDS) or min(small_counts) > 0, (w, small_counts)
        for name, e in _g1_check(small, rng).items():
            err[name] = max(err[name], e)
    # the doubling at more widths
    for w in M_DOUBLE_WIDTHS:
        small, small_counts = _g1_inputs(rng, w)
        assert min(small_counts) > 0, (w, small_counts)
        e = same3(gf.double_lf(gf.G1LF(*small[:3])), gf._double_plain(*small[:3]))
        err["g1_double"] = max(err["g1_double"], e)
    # the three adders (a lane over several threads) also at more widths of
    # the bucket reduction
    for w in M_SPREAD_WIDTHS:
        small, small_counts = _g1_inputs(rng, w)
        assert min(small_counts) > 0, (w, small_counts)
        for name, e in _g1_check(small, rng, spread_only=True).items():
            err[name] = max(err[name], e)
    _g1_on_the_curve(rng)
    x1, y1, z1, x2, y2, z2, sign, valid = args
    kept = int(((valid != 0) & (y2.amax(dim=0, keepdim=True) != 0)).sum().item())
    n_valid = int((valid != 0).sum().item())
    coord = 4 * L * m
    P3 = lambda a: gf.G1LF(*a[:3])
    Q3 = lambda a: gf.G1LF(*a[3:6])
    specs = {       # name -> (launch, plain, argument tuple, sets, bytes, mads)
        "g1_double": (lambda a: gf.double_lf(P3(a)), lambda: gf._double_plain(x1, y1, z1),
                      (x1, y1, z1), 4, 6 * coord, 8 * MADS_PER_PRODUCT * m),
        "g1_add": (lambda a: gf.add_lf(P3(a), Q3(a)),
                   lambda: gf._add_plain(x1, y1, z1, x2, y2, z2),
                   (x1, y1, z1, x2, y2, z2), 3, 9 * coord, 12 * MADS_PER_PRODUCT * m),
        "g1_add_sel": (lambda a: gf.add_sel_lf(P3(a), a[3], a[4], a[5], a[6]),
                       lambda: gf._add_sel_plain(x1, y1, z1, x2, y2, sign, valid),
                       (x1, y1, z1, x2, y2, sign, valid), 3, 8 * coord + 8 * m,
                       11 * MADS_PER_PRODUCT * kept),
        "g1_add_sel_proj": (lambda a: gf.add_sel_proj_lf(P3(a), Q3(a), a[6], a[7]),
                            lambda: gf._add_sel_proj_plain(*args),
                            args, 3, 9 * coord + 8 * m, 12 * MADS_PER_PRODUCT * n_valid),
        "g1_normalize": (lambda a: gf.normalize_lf(P3(a)),
                         lambda: gf._normalize_plain(x1, y1, z1),
                         (x1, y1, z1), 4, 6 * coord, 0),
    }
    for name, (launch, plain, a, sets, nbytes, mads) in specs.items():
        res[name] = {
            "max_abs_err": err[name], "lanes": m,
            "ms": kernel_ms(launch, copies(a, sets)),
            "plain_ms": cuda_ms(plain, 3), "bytes": nbytes, "mads": mads,
        }
    # the doubling at the narrow end of the bucket reduction (one lane for
    # each window) and at its scan steps; registers, spills and shared
    # memory from the build log
    ptxas = _build.ptxas_info()
    for w in M_DOUBLE_TIMED:
        part = tuple(t[:, :w].contiguous() for t in args[:3])
        res["g1_double"][f"ms_{w}_lanes"] = kernel_ms(specs["g1_double"][0], copies(part, 4))
    res["g1_double"]["ptxas"] = ptxas.get("g1_double_kernel", "not built in this process")
    # the three adders at the reduction's narrow widths; registers, spills
    # and shared memory from the build log
    for name, cols in (("g1_add", range(6)), ("g1_add_sel", (0, 1, 2, 3, 4, 6, 7)),
                       ("g1_add_sel_proj", range(8))):
        for w in (M_WINDOWS, 704, 1408):
            part = tuple(args[i][:, :w].contiguous() for i in cols)
            res[name][f"ms_{w}_lanes"] = kernel_ms(specs[name][0], copies(part, 4))
        res[name]["ptxas"] = ptxas.get(name + "_kernel", "not built in this process")
    res["g1_add_sel"].update(kept_lanes=kept, planted=dict(zip(G1_KINDS, counts)))
    res["g1_add_sel_proj"]["valid_lanes"] = n_valid
    # g1_add_sel_proj where half or few lanes are valid, as in the later
    # steps of the top-window merge
    rows = _valid_rows(rng, valid)
    for vname in ("half", "few"):
        a = (*args[:7], rows[vname])
        res["g1_add_sel_proj"][f"ms_{vname}_valid"] = kernel_ms(specs["g1_add_sel_proj"][0],
                                                                copies(a, 3))
        res["g1_add_sel_proj"][f"{vname}_valid_lanes"] = int(rows[vname].sum().item())


def _proto_operands(rng, m, p, bound, n_limbs):
    """Two (n_limbs, m) operand tensors of values < bound, with 0, 1, p - 1, in every pairing (where m has room)."""
    edge = [0, 1, p - 1, p, 2 * p - 1, bound - 1]
    a = [rng.randrange(bound) for _ in range(m)]
    b = [rng.randrange(bound) for _ in range(m)]
    for i, (u, v) in enumerate([(u, v) for u in edge for v in edge][:m]):
        a[i], b[i] = u, v
    as_t = lambda v: limbs.to_tensor(limbs.ints_to_limbs(v, n_limbs).T, DEV)
    return as_t(a), as_t(b), (a, b)


def _proto_kernels(res):
    """fq_mul_canon, fq_mul_chain12, fr_mul against their plain versions: raw
    limbs equal bit for bit, no normalize; a few lanes against host
    integers; and their times."""
    rng = random.Random(SEED + 12)
    m = M_PROTO
    FRL = params.FR_LIMBS
    specs = {   # name -> (wrapper, plain, modulus, operand bound, limbs, mads per element)
        "fq_mul_canon": (pm.fq_mul_canon, pm.fq_mul_canon_plain, Q, 2 * Q, L, MADS_PER_PRODUCT),
        "fq_mul_chain12": (pm.fq_mul_chain12, pm.fq_mul_chain12_plain, Q, 2 * Q, L,
                           12 * MADS_PER_PRODUCT),
        "fr_mul": (pm.fr_mul, pm.fr_mul_plain, R, 4 * R, FRL, MADS_PER_FR_PRODUCT),
    }
    for name, (fn, plain, p, bound, nl, mads) in specs.items():
        err = 0
        for w in (m, 1, 129, 1001):
            a, b, (ai, bi) = _proto_operands(rng, w, p, bound, nl)
            got, want = fn(a, b), plain(a, b)
            torch.cuda.synchronize()
            assert got.shape == (nl, w) and got.dtype == torch.int32
            err = max(err, int_err(got, want))
            # against host integers on the first lanes (the planted ones)
            radix = 1 << (16 * nl)
            head = limbs.limbs_to_ints(limbs.to_numpy(got[:, :40]).T)
            if name == "fr_mul":        # the lazy integer (ab + m r) / R itself
                n_prime = (-pow(p, -1, radix)) % radix
                ints = [(x * y + (x * y * n_prime % radix) * p) >> (16 * nl)
                        for x, y in zip(ai[:40], bi[:40])]
            else:
                r_inv = pow(radix, -1, p)
                x, y = ai[:40], bi[:40]
                for _ in range(1 if name == "fq_mul_canon" else pm.CHAIN_ROUNDS):
                    x, y = ([u * v * r_inv % p for u, v in zip(x, y)],
                            [v * u * r_inv % p for u, v in zip(x, y)])
                ints = x
            assert head == ints, f"{name} disagrees with host integers at width {w}"
        a, b, _ = _proto_operands(rng, m, p, bound, nl)
        n_sets = -(-60_000_000 // (3 * 4 * nl * m))         # more than the L2 in all
        res[name] = {
            "max_abs_err": err, "lanes": m,
            "ms": kernel_ms(lambda t: fn(*t), copies((a, b), n_sets)),
            "plain_ms": cuda_ms(lambda: plain(a, b), 3),
            "bytes": 3 * 4 * nl * m, "mads": mads * m,
        }
    # the redesigned canonical product: its registers, and its time at the
    # narrow widths it is held at
    res["fq_mul_canon"]["ptxas"] = _build.ptxas_info().get("fq_mul_canon_kernel",
                                                           "not built in this process")
    for w in (1, 129, 1001):
        a, b, _ = _proto_operands(rng, w, Q, 2 * Q, L)
        res["fq_mul_canon"][f"ms_{w}_lanes"] = kernel_ms(lambda t: pm.fq_mul_canon(*t),
                                                         copies((a, b), 4))


def random_fr(n, seed):
    """(16, n) raw 16-bit limbs of uniform values below 0x12AB * 2^240 < p,
    made on the card from a seed."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    x = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device=DEV, generator=g)
    x[15] %= R >> 240
    return x


def int_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _plant(cols, top):
    """Hard columns among real ones: zeros; all 127 with a carry entering at
    the bottom (a ripple through every limb) and in the middle; `top` in
    every row (the largest sums the producer can make)."""
    K = cols.shape[0]
    cols[:, 0] = 0
    cols[:, 1] = 127
    cols[0, 1] = 128
    cols[:, 2] = 127
    cols[K // 2, 2] = 255
    cols[:, 3] = top


def _stage_product(M, seed):
    """The first stage of an M-lane MatNTT on the card: its DFT bank, packed
    random inputs and their int8 product (the stage's raw columns)."""
    p = matntt.plan(M, False, 1)
    d = p.dims[0]                                           # 64
    bank = p.dev(("dft", 0), p.dft_banks[0], DEV)           # (76 * 64, 38 * 64) int8
    x7 = fmat.pack7(random_fr(M, seed)).reshape(fmat.L7 * d, M // d)
    x7[:, 0] = 127          # one lane of the largest limbs: its sums pass 2^24
    return bank, x7, torch._int_mm(bank, x7)                # (76 * 64, M / 64) int32


def _stage_columns(prod, M):
    """The stage's (76, M) raw columns, the hard columns planted among them."""
    L7, K7 = fmat.L7, fmat.K7
    d = prod.shape[0] // K7
    t_cols = prod.reshape(K7, M).clone()
    full = torch.arange(1, K7 + 1, device=DEV).clamp(max=L7) * (d * 127 * 127)
    _plant(t_cols, full.to(torch.int32))
    return t_cols


def _fmat_kernels(res):
    """fmat_reduce, fmat_carry2d, fmat_carry3d against their plain versions,
    and the two library products against exact ones."""
    L7, K7, M = fmat.L7, fmat.K7, M_STAGE
    bank, x7, prod = _stage_product(M, SEED + 7)
    # exactness of the int8 product: float64 holds every partial sum (< 2^53)
    # exactly; and an int64 product of 64 lanes on the host
    exact = (bank.double() @ x7.double()).to(torch.int64)
    int_mm_err = int_err(prod, exact)
    host = bank.cpu().to(torch.int64) @ x7[:, :64].cpu().to(torch.int64)
    int_mm_err = max(int_mm_err, int_err(prod[:, :64].cpu(), host))
    del exact
    assert int_mm_err == 0, "torch._int_mm is not exact"
    assert int(prod.max().item()) > 1 << 24, "the stage's sums should pass 2^24"

    t_cols = _stage_columns(prod, M)
    got = fk.mont_reduce8(t_cols)
    want = fk._reduce_plain(t_cols)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (L7, M)
    res["fmat_reduce"] = {
        "max_abs_err": int_err(got, want), "lanes": M,
        "ms": kernel_ms(lambda a: fk.mont_reduce8(*a), copies((t_cols,), 2)),
        "plain_ms": cuda_ms(lambda: fk._reduce_plain(t_cols), 3),
        "bytes": (K7 * 4 + L7) * M, "mads": REDUCE_MADS * M,
    }
    # a ragged width: the last block is masked, nothing is padded
    rag = t_cols[:, : M - 37].contiguous()
    assert int_err(fk.mont_reduce8(rag), want[:, : M - 37]) == 0, "fmat_reduce, ragged width"

    # fmat_carry2d: the chain's first carry (76 rows, 4 peels) and its second
    # (38 rows, 3 peels, on the N' band product of the first one's digits)
    Wnp, _ = fmat._reduce_mats_dev(str(DEV))
    m_cols = fmat._band_dot(Wnp, fk._carry_plain(t_cols[:L7], 4, 0), 0).contiguous()
    _plant(m_cols, L7 * 127 * 127)
    err, times = 0, {}
    for cols, peels in ((t_cols, 4), (m_cols, 3), (rag, 4), (m_cols[:, :1001].contiguous(), 3)):
        err = max(err, int_err(fk.carry8(cols, peels, 0), fk._carry_plain(cols, peels, 0)))
    for key, cols, peels in (("ms", t_cols, 4), ("ms_38_rows", m_cols, 3)):
        n_sets = -(-60_000_000 // (cols.numel() * 5))
        times[key] = kernel_ms(lambda a: fk.carry8(a[0], peels, 0), copies((cols,), n_sets))
    res["fmat_carry2d"] = {
        "max_abs_err": err, "lanes": M, **times,
        "plain_ms": cuda_ms(lambda: fk._carry_plain(t_cols, 4, 0), 3),
        "bytes": 5 * K7 * M, "mads": 0,
    }

    # fmat_carry3d at (512, 76, 256): the raw output of a Toeplitz batch
    rng = random.Random(SEED + 8)
    B, T = 512, 256
    tbank = torch.from_numpy(fmat.toeplitz_bank_np([rng.randrange(R) for _ in range(B)])).to(DEV)
    xb = fmat.pack7(random_fr(B * T, SEED + 9)).reshape(L7, B, T).permute(1, 0, 2).contiguous()
    raw = torch.bmm(tbank.float(), xb.float())
    exact = torch.bmm(tbank.double(), xb.double()).to(torch.int64)
    bmm_err = int_err(raw.to(torch.int64), exact)
    host = torch.bmm(tbank[:8].cpu().to(torch.int64), xb[:8].cpu().to(torch.int64))
    bmm_err = max(bmm_err, int_err(raw[:8].cpu().to(torch.int64), host))
    assert bmm_err == 0, "the float32 bmm is not exact"
    t3 = raw.to(torch.int32)
    t3[0] = t_cols[:, :T]                  # the planted columns, in this layout
    got3 = fk.carry8(t3, 4, 1)
    torch.cuda.synchronize()
    assert got3.dtype == torch.int8 and got3.shape == (B, K7, T)
    err = int_err(got3, fk._carry_plain(t3, 4, 1))
    rag3 = t3[:5, :, :77].contiguous()
    err = max(err, int_err(fk.carry8(rag3, 4, 1), fk._carry_plain(rag3, 4, 1)))
    res["fmat_carry3d"] = {
        "max_abs_err": err, "lanes": B * T,
        "ms": kernel_ms(lambda a: fk.carry8(a[0], 4, 1), copies((t3,), 2)),
        "plain_ms": cuda_ms(lambda: fk._carry_plain(t3, 4, 1), 3),
        "bytes": 5 * B * K7 * T, "mads": 0,
    }
    # the toeplitz path whole, against host integers on a few lanes
    consts = [rng.randrange(R) for _ in range(8)]
    y = fmat.toeplitz_apply(torch.from_numpy(fmat.toeplitz_bank_np(consts)).to(DEV), xb[:8])
    vals = [fmat.decode7(xb[b, :, :4]) for b in range(8)]
    for b in range(8):
        assert fmat.decode7(y[b, :, :4]) == [consts[b] * v % R for v in vals[b]], "toeplitz_apply"
    return {"int_mm_max_abs_err": int_mm_err, "bmm_max_abs_err": bmm_err,
            "int_mm_shape": [list(bank.shape), list(x7.shape)],
            "bmm_shape": [list(tbank.shape), list(xb.shape)]}


def _msm_batch(srs):
    """msm_batch_host with k = 4 over the first 32768 SRS powers in both MSM
    modes, against msm_fast_host one by one."""
    n, k = MSM_BATCH_N, MSM_BATCH_K
    pw = srs.powers
    table = msm_mod.make_table(g1mod.G1Points(pw.x[:n], pw.y[:n], pw.z[:n]))
    raw = random_fr(k * n, SEED + 5).T.reshape(k, n, params.FR_LIMBS).contiguous()
    out, points = {}, {}
    assert config.MSM_AFFINE_MODE == "1"
    try:
        for mode, name in (("1", "affine"), ("0", "projective")):
            config.MSM_AFFINE_MODE = mode
            # each twice: a first call at a size pays the allocator's growth
            batch = lambda: msm_mod.msm_batch_host(raw, table)
            four = lambda: [msm_mod.msm_fast_host(raw[p], table) for p in range(k)]
            reset_launches()
            got, batch_first_s = _timed(batch)
            batch_launches = all_launches()
            reset_launches()
            singles, singles_first_s = _timed(four)
            singles_launches = all_launches()
            _, batch_s = _timed(batch)
            _, singles_s = _timed(four)
            assert got == singles, f"msm_batch_host ({name}) disagrees with msm_fast_host"
            assert all(pt is not None for pt in got)
            points[name] = got
            out[name] = {"batch_seconds": batch_s, "batch_first_seconds": batch_first_s,
                         "batch_launches": batch_launches,
                         "four_single_seconds": singles_s,
                         "four_single_first_seconds": singles_first_s,
                         "four_single_launches": singles_launches}
    finally:
        config.MSM_AFFINE_MODE = "1"
    assert points["affine"] == points["projective"], "the modes disagree on a batch MSM"
    for kname in AFFINE_KERNELS:
        assert out["affine"]["batch_launches"][kname] > 0, kname
        assert out["projective"]["batch_launches"][kname] == 0, kname
    assert out["affine"]["batch_launches"]["fq_mul"] == 0, "fq_mul ran in msm_batch_host"
    for kname in PROJECTIVE_KERNELS + ("g1_normalize",):
        assert out["projective"]["batch_launches"][kname] > 0, kname
    return {"points": n, "k": k, "c": msm_mod.auto_c(n), **out}


def phase_msm(srs):
    t0 = time.time()
    rng = random.Random(SEED + 1)
    n = 1 << 12
    g = G1.generator()
    p = G1.mul(rng.randrange(1, R), g)
    pts = []
    for _ in range(n):
        pts.append(p)
        p = G1.add(p, g)
    rng.shuffle(pts)
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0], scalars[1], scalars[2], pts[3] = 0, R - 1, 1, None
    want = msm_pippenger_jac(scalars, pts)
    raw = limbs.to_tensor(limbs.ints_to_limbs(scalars, params.FR_LIMBS), DEV)
    enc = g1mod.encode_points(pts, device=DEV)
    modes = {}
    assert config.MSM_AFFINE_MODE == "1"
    try:
        for mode, name in (("1", "affine"), ("0", "projective")):
            config.MSM_AFFINE_MODE = mode
            reset_launches()
            got, host_s = _timed(lambda: msm_mod.msm_host(scalars, pts, device=DEV))
            assert got == want, f"msm_host ({name}) disagrees with the oracle"
            host_launches = all_launches()
            # the device entry point, window combine on the card
            reset_launches()
            acc, entry_s = _timed(lambda: msm_mod.msm(raw, enc, c=4))
            assert acc.x.shape == (L,) and acc.x.is_cuda
            assert g1mod.decode_points(acc) == [want], f"msm ({name}) disagrees with the oracle"
            modes[name] = {"msm_host_seconds": host_s, "msm_host_launches": host_launches,
                           "msm_c4_seconds": entry_s, "msm_c4_launches": all_launches()}
    finally:
        config.MSM_AFFINE_MODE = "1"
    for k in AFFINE_KERNELS:
        assert modes["affine"]["msm_host_launches"][k] > 0
        assert modes["projective"]["msm_host_launches"][k] == 0
        assert modes["projective"]["msm_c4_launches"][k] == 0
    for mode in modes.values():
        assert mode["msm_host_launches"]["fq_mul"] == 0, "fq_mul ran in an MSM"
    for k in ("g1_add", "g1_add_sel", "g1_normalize"):
        assert modes["projective"]["msm_host_launches"][k] > 0, k
    for k in ("g1_double", "g1_add", "g1_add_sel", "g1_normalize"):
        assert modes["projective"]["msm_c4_launches"][k] > 0, k
    # the limbs-last group law on the card: scale, neg, select, to_affine
    k = rng.randrange(1, 1 << 32)
    two = g1mod.G1Points(*(a[:2] for a in enc))
    kp = g1mod.scale(g1mod.scalar_bits(k, 32), two)
    assert g1mod.decode_points(kp) == [G1.mul(k, p) for p in pts[:2]], "g1.scale"
    sel = g1mod.select(torch.tensor([True, False], device=DEV), kp, g1mod.neg(kp))
    reset_launches()                # the path of fq_mul
    aff = g1mod.to_affine(sel)
    torch.cuda.synchronize()
    to_affine_launches = {k: v for k, v in all_launches().items() if v}
    assert to_affine_launches.get("fq_mul", 0) > 0, "to_affine did not launch fq_mul"
    assert g1mod.decode_points(aff) == [G1.mul(k, pts[0]), G1.neg(G1.mul(k, pts[1]))]
    one = g1mod.identity((2,), device=DEV).y
    assert torch.equal(aff.z, one) and not g1mod.is_identity(aff).any(), "g1.to_affine"
    msm_s = modes["affine"]["msm_host_seconds"]
    launches = {k: modes["affine"]["msm_host_launches"][k] for k in AFFINE_KERNELS}

    n = 1 << 17
    coeffs = [rng.randrange(R) for _ in range(n)]
    a = lf.encode(coeffs, device=DEV)
    t1 = time.time()
    ev = dntt.ntt_lf(a)
    torch.cuda.synchronize()
    ntt_s = time.time() - t1
    assert lf.decode(dntt.intt_lf(ev)) == coeffs, "NTT round trip failed at 2^17"
    dom = dntt.domain(n)
    shift = params.FR_GENERATOR
    t1 = time.time()
    cev = dntt.coset_ntt_lf(a, shift)
    torch.cuda.synchronize()
    coset_s = time.time() - t1
    idx = [0, 1, 77777, n - 1]
    ev_h = lf.decode(ev[:, idx])
    cev_h = lf.decode(cev[:, idx])
    for k, i in enumerate(idx):
        x = pow(dom.w, i, R)
        assert ev_h[k] == rpoly.evaluate(coeffs, x), f"NTT wrong at {i}"
        assert cev_h[k] == rpoly.evaluate(coeffs, shift * x % R), f"coset NTT wrong at {i}"
    say({"phase": "msm", "msm_points": 1 << 12, "msm_seconds": msm_s,
         "msm_launches": launches, "msm_modes": modes,
         "to_affine_launches": to_affine_launches, "msm_batch": _msm_batch(srs),
         "ntt_lanes": n, "ntt_seconds": ntt_s,
         "coset_ntt_seconds": coset_s, "seconds": round(time.time() - t0, 3)})
    return to_affine_launches


def _timed(fn):
    torch.cuda.synchronize()
    t1 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t1


def phase_matntt():
    """Both NTT paths at the MatNTT sizes of a transfer proof."""
    t0 = time.time()
    rng = random.Random(SEED + 2)
    shift = params.FR_GENERATOR
    calls = {
        "ntt_lf": lambda x: dntt.ntt_lf(x),
        "intt_lf": lambda x: dntt.intt_lf(x),
        "coset_ntt_lf": lambda x: dntt.coset_ntt_lf(x, shift),
        "coset_intt_lf": lambda x: dntt.coset_intt_lf(x, shift),
    }
    threshold = config.MATNTT_MIN_N
    assert threshold == 1 << 14 and config.FUSED_REDUCE
    sizes = {}
    reset_launches()
    for logn in (14, 15, 17):
        n = 1 << logn
        assert dntt._use_matntt(n)
        coeffs = [rng.randrange(R) for _ in range(n)]
        a = lf.encode(coeffs, device=DEV)
        row = {}
        outs = {}
        for name, fn in calls.items():
            before = fk.LAUNCHES["fmat_reduce"]
            outs[name], first = _timed(lambda: fn(a))
            reduces = fk.LAUNCHES["fmat_reduce"] - before
            assert reduces > 0, f"{name} at 2^{logn} did not run MatNTT"
            _, second = _timed(lambda: fn(a))
            row[name] = {"matntt_first_s": first, "matntt_s": second,
                         "fmat_reduce_launches": reduces}
        config.MATNTT_MIN_N = 1 << 40                   # the butterfly network
        try:
            for name, fn in calls.items():
                before = fk.LAUNCHES["fmat_reduce"]
                ref, first = _timed(lambda: fn(a))
                _, second = _timed(lambda: fn(a))
                assert fk.LAUNCHES["fmat_reduce"] == before
                row[name].update(butterfly_first_s=first, butterfly_s=second)
                assert torch.equal(lf.normalize(outs[name]), lf.normalize(ref)), \
                    f"MatNTT {name} disagrees with the butterfly at 2^{logn}"
        finally:
            config.MATNTT_MIN_N = threshold
        # against the host: evaluations at a few indices, and the round trips
        dom = dntt.domain(n)
        idx = [0, 1, n // 3, n - 1]
        ev_h = lf.decode(outs["ntt_lf"][:, idx])
        cev_h = lf.decode(outs["coset_ntt_lf"][:, idx])
        for k, i in enumerate(idx):
            x = pow(dom.w, i, R)
            assert ev_h[k] == rpoly.evaluate(coeffs, x), f"MatNTT wrong at {i}"
            assert cev_h[k] == rpoly.evaluate(coeffs, shift * x % R), f"coset MatNTT wrong at {i}"
        canon = lf.normalize(a)
        assert torch.equal(lf.normalize(dntt.intt_lf(outs["ntt_lf"])), canon)
        assert torch.equal(
            lf.normalize(dntt.coset_intt_lf(outs["coset_ntt_lf"], shift)), canon)
        sizes[str(n)] = row

    # the unfused configuration on a real path: the chain of carry kernels
    n = 1 << 17
    a = random_fr(n, SEED + 3)
    fused = dntt.ntt_lf(a)
    before = dict(fk.LAUNCHES)
    config.FUSED_REDUCE = False
    try:
        unfused, unfused_s = _timed(lambda: dntt.ntt_lf(a))
    finally:
        config.FUSED_REDUCE = True
    assert fk.LAUNCHES["fmat_reduce"] == before["fmat_reduce"]
    carries = fk.LAUNCHES["fmat_carry2d"] - before["fmat_carry2d"]
    assert carries > 0, "the unfused reduction did not launch fmat_carry2d"
    assert torch.equal(unfused, fused), "unfused reduction disagrees with fmat_reduce"
    _, fused_s = _timed(lambda: dntt.ntt_lf(a))

    # the batched entry point at (4, 2^15)
    xb = random_fr(4 << 15, SEED + 4).reshape(16, 4, 1 << 15).transpose(0, 1).contiguous()
    yb, batch_first = _timed(lambda: matntt.ntt_batch_lf16(xb))
    _, batch_s = _timed(lambda: matntt.ntt_batch_lf16(xb))
    assert yb.shape == xb.shape
    config.MATNTT_MIN_N = 1 << 40
    try:
        for i in range(4):
            assert torch.equal(lf.normalize(yb[i]), lf.normalize(dntt.ntt_lf(xb[i]))), \
                f"ntt_batch_lf16 disagrees with the butterfly in row {i}"
    finally:
        config.MATNTT_MIN_N = threshold
    say({"phase": "matntt", "sizes": sizes,
         "unfused_2p17": {"seconds": unfused_s, "fused_seconds": fused_s,
                          "fmat_carry2d_launches": carries},
         "batch_4x2p15": {"first_s": batch_first, "seconds": batch_s},
         "launches": dict(fk.LAUNCHES), "seconds": round(time.time() - t0, 3)})


def phase_micro(srs):
    t0 = time.time()
    reg = Registry()
    reg.add(parse_program(MICRO))
    t1 = time.time()
    keys = pipeline.synthesize_keys(reg, "micro.aleo", "bump", srs=srs, cache=False)
    torch.cuda.synchronize()
    keys_s = time.time() - t1
    t1 = time.time()
    ep = pipeline.prove_execution(keys, reg, [Value("u64", 41)], rng=random.Random(7))
    torch.cuda.synchronize()
    prove_s = time.time() - t1
    assert ep.transition.outputs[0].data == 42
    t1 = time.time()
    assert pipeline.verify_execution(keys, ep), "micro proof does not verify"
    say({"phase": "micro", "n": keys.index.n, "m": keys.index.m,
         "keys_seconds": keys_s, "prove_seconds": prove_s,
         "verify_seconds": time.time() - t1, "seconds": round(time.time() - t0, 3)})


def transfer_inputs(amount):
    """token.aleo/transfer's inputs (the vector file's transfer entry)."""
    rec = Record(
        "token.aleo", "token", owner=SENDER, gates=0,
        entries={"amount": Value("u64", 500)}, nonce=7,
    )
    return [rec, Value("address", RECEIVER), Value("u64", amount)]


def phase_transfer(srs):
    """The main path, at the full size of token.aleo/transfer."""
    t0 = time.time()
    reg = load_example("simple_token")
    sender = SENDER
    inputs = transfer_inputs(TRANSFER_AMOUNT)

    reset_launches()                      # every kernel's count to 0
    prof.reset()
    prof.enable()
    t1 = time.time()
    keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
    torch.cuda.synchronize()
    keys_s = time.time() - t1
    keys_launches = all_launches()
    t1 = time.time()
    ep = pipeline.prove_execution(keys, reg, inputs, caller=sender,
                                  rng_nonce=lambda: RNG_NONCE, rng=random.Random(SEED))
    torch.cuda.synchronize()
    prove_s = time.time() - t1
    t1 = time.time()
    ok = pipeline.verify_execution(keys, ep, debug=True)
    verify_s = time.time() - t1
    launches = all_launches()             # the main path's counts
    stages = prof.report()
    prof.enable(False)

    proof_launches = {k: launches[k] - keys_launches[k] for k in launches}
    assert ok, "transfer proof does not verify"
    assert [r.entries["amount"].data for r in ep.transition.created_records] == [120, 380]
    bad = list(ep.public_inputs)
    bad[2] = (bad[2] + 1) % R
    assert not verify(keys.vk, bad, ep.proof), "tampered public input was accepted"
    assert (keys.index.n, keys.index.m) == (8192, 32768), (keys.index.n, keys.index.m)
    # the proof goes through the four MSM kernels, through g1_normalize where
    # window totals are decoded on the card and, at the default MatNTT
    # threshold, through fmat_reduce; the carry kernels belong to the unfused
    # configuration (phase matntt drives it) and stay at 0 here
    for k in AFFINE_KERNELS + ("g1_normalize", "fmat_reduce"):
        assert proof_launches[k] > 0, f"{k} was never launched during the proof"
    # the inversion tree runs on its own kernels: fq_mul belongs to to_affine
    assert proof_launches["fq_mul"] == 0, "fq_mul was launched during the proof"

    # the same proof through the projective MSM: same keys, inputs and
    # randomness, so the same commitments and the same bytes
    assert config.MSM_AFFINE_MODE == "1"
    config.MSM_AFFINE_MODE = "0"
    try:
        reset_launches()
        prof.reset()
        prof.enable()
        t1 = time.time()
        ep_proj = pipeline.prove_execution(keys, reg, inputs, caller=sender,
                                           rng_nonce=lambda: RNG_NONCE, rng=random.Random(SEED))
        torch.cuda.synchronize()
        proj_prove_s = time.time() - t1
        proj_launches = all_launches()    # the projective path's counts
        proj_stages = prof.report()
        prof.enable(False)
    finally:
        config.MSM_AFFINE_MODE = "1"
    assert pipeline.verify_execution(keys, ep_proj, debug=True), \
        "projective transfer proof does not verify"
    # the key, the public inputs and both proofs against the JAX package's
    # (equal bytes in both modes imply the two proofs' equality)
    t1 = time.time()
    want = JAX["transfer"]
    vk = keys.vk
    held("transfer", {"n": vk.n, "m": vk.m, "ell": vk.ell,
                      "index_commitments": [point_to_bytes(p).hex()
                                            for p in vk.index_commitments]} == want["vk"],
         "the verifying key")
    held("transfer", [str(v) for v in ep.public_inputs] == want["public_inputs"],
         "the public inputs")
    dims = (keys.index.n, keys.index.m, keys.index.ell)
    held("transfer", proof_to_bytes(ep.proof, *dims).hex() == want["proof"],
         "the batch-affine proof")
    held("transfer", proof_to_bytes(ep_proj.proof, *dims).hex() == want["proof"],
         "the projective proof")
    vectors_s = time.time() - t1
    for k in PROJECTIVE_KERNELS + ("g1_normalize", "fmat_reduce"):
        assert proj_launches[k] > 0, f"{k} was never launched during the projective proof"
    for k in AFFINE_KERNELS:
        assert proj_launches[k] == 0, f"{k} was launched during the projective proof"
    for k in PROJECTIVE_KERNELS:
        assert proof_launches[k] == 0, f"{k} was launched during the affine proof"
    say({"phase": "transfer", "n": keys.index.n, "m": keys.index.m, "ell": keys.index.ell,
         "constraints": keys.constraint_counts["total"],
         "keys_seconds": keys_s,
         "synthesis_seconds": stages["pipeline/synthesize"]["seconds"],
         "prove_seconds": prove_s, "verify_seconds": verify_s,
         "launches_keys": keys_launches, "launches_proof": proof_launches,
         "stages": stages,
         "projective": {"prove_seconds": proj_prove_s, "launches_proof": proj_launches,
                        "stages": proj_stages, "bytes_equal": True},
         "jax_vectors": {"transfer": True}, "jax_vectors_seconds": vectors_s,
         "peak_device_bytes": torch.cuda.max_memory_allocated(),
         "seconds": round(time.time() - t0, 3)})
    # each kernel's count on the path that runs it: the batch-affine main path
    # (keys, proof, verification), and the projective proof for the kernels
    # of the projective pipeline
    path = {**launches, **{k: proj_launches[k] for k in PROJECTIVE_KERNELS}}
    return path, keys, {"affine": prove_s, "projective": proj_prove_s}


def credits_inputs(fn):
    """One credits.aleo function's inputs (the vector file's credits entry):
    its records, owned by the caller, then the receiver and the amount where
    it takes them."""
    spec = CREDITS["functions"][fn]
    out = [Record("credits.aleo", "credits", owner=CREDITS["caller"], gates=0,
                  entries={"microcredits": Value("u64", mc)}, nonce=nonce)
           for mc, nonce in spec.get("records", [])]
    if "receiver" in spec:
        out.append(Value("address", spec["receiver"]))
    if "amount" in spec:
        out.append(Value("u64", spec["amount"]))
    return out


def _prove_credits(keys, reg, fn):
    return pipeline.prove_execution(keys, reg, credits_inputs(fn), caller=CREDITS["caller"],
                                    rng_nonce=lambda: CREDITS["rng_nonce"],
                                    rng=random.Random(CREDITS["rng_seed"]))


def phase_credits(srs):
    """credits.aleo at its three shapes, as the dev server, the worker and
    the CLI prove it, held against the JAX package's keys and proofs."""
    t0 = time.time()
    reg = registry_with_credits()
    res, keys_of, eps = {}, {}, {}
    reset_launches()                      # every kernel's count to 0
    for fn, spec in CREDITS["functions"].items():
        keys, keys_s = _timed(lambda: pipeline.synthesize_keys(
            reg, CREDITS["program"], fn, srs=srs, cache=False))
        assert (keys.index.n, keys.index.m) == (spec["n"], spec["m"]), \
            (fn, keys.index.n, keys.index.m)
        ep, prove_s = _timed(lambda: _prove_credits(keys, reg, fn))
        ok, verify_s = _timed(lambda: pipeline.verify_execution(keys, ep, debug=True))
        assert ok, f"credits.aleo/{fn} proof does not verify"
        keys_of[fn], eps[fn] = keys, ep
        res[fn] = {"n": keys.index.n, "m": keys.index.m, "ell": keys.index.ell,
                   "constraints": keys.constraint_counts["total"], "keys_seconds": keys_s,
                   "prove_seconds": prove_s, "verify_seconds": verify_s}
    launches = all_launches()             # keys, proofs and verifications
    for k in AFFINE_KERNELS + ("g1_normalize", "fmat_reduce"):
        assert launches[k] > 0, f"{k} was never launched by the credits proofs"
    for k in PROJECTIVE_KERNELS:
        assert launches[k] == 0, f"{k} was launched by the batch-affine credits proofs"

    # join (m/n = 8) again through the projective MSM
    keys = keys_of["join"]
    assert config.MSM_AFFINE_MODE == "1"
    config.MSM_AFFINE_MODE = "0"
    try:
        reset_launches()
        ep_proj, proj_s = _timed(lambda: _prove_credits(keys, reg, "join"))
        proj_launches = all_launches()
    finally:
        config.MSM_AFFINE_MODE = "1"
    assert pipeline.verify_execution(keys, ep_proj, debug=True), \
        "projective join proof does not verify"
    for k in PROJECTIVE_KERNELS + ("g1_normalize", "fmat_reduce"):
        assert proj_launches[k] > 0, f"{k} was never launched during the projective join"
    for k in AFFINE_KERNELS:
        assert proj_launches[k] == 0, f"{k} was launched during the projective join"
    bad = list(eps["join"].public_inputs)
    bad[2] = (bad[2] + 1) % R
    assert not verify(keys.vk, bad, eps["join"].proof), "tampered join input was accepted"
    res["join"]["projective"] = {"prove_seconds": proj_s, "launches": _nonzero(proj_launches)}

    # every key, public input and proof against the JAX package's
    t1 = time.time()
    for fn, want in JAX["credits"]["functions"].items():
        vk, ep = keys_of[fn].vk, eps[fn]
        held("credits", {"n": vk.n, "m": vk.m, "ell": vk.ell,
                         "index_commitments": [point_to_bytes(p).hex()
                                               for p in vk.index_commitments]} == want["vk"],
             f"{fn}'s verifying key")
        held("credits", [str(v) for v in ep.public_inputs] == want["public_inputs"],
             f"{fn}'s public inputs")
        held("credits", proof_to_bytes(ep.proof, vk.n, vk.m, vk.ell).hex() == want["proof"],
             f"{fn}'s batch-affine proof")
    vk = keys_of["join"].vk
    held("credits", proof_to_bytes(ep_proj.proof, vk.n, vk.m, vk.ell).hex()
         == JAX["credits"]["functions"]["join"]["proof"], "join's projective proof")
    vectors_s = time.time() - t1
    say({"phase": "credits", **res,
         "jax_vectors": {"credits": True}, "jax_vectors_seconds": vectors_s,
         "launches": _nonzero(launches), "seconds": round(time.time() - t0, 3)})
    # each kernel's count on the path that runs it: the batch-affine keys,
    # proofs and verifications, and the projective join for its kernels
    return {**launches, **{k: proj_launches[k] for k in PROJECTIVE_KERNELS}}


def _prove_batch_timed(keys, cs_list):
    """One prove_batch with every count set to 0 just before and read just
    after -> (proofs, seconds, launches, batched transforms, stage timers,
    peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    batch_mod.reset_ntt_calls()
    prof.reset()
    prof.enable()
    t1 = time.time()
    proofs = batch_mod.prove_batch(keys.index, cs_list, rng=random.Random(SEED))
    torch.cuda.synchronize()
    seconds = time.time() - t1
    launches = all_launches()
    stages = prof.report()
    prof.enable(False)
    return (proofs, seconds, launches, dict(batch_mod.NTT_CALLS), stages,
            torch.cuda.max_memory_allocated())


def phase_batch(srs, keys, single_s):
    """The batch prover at the full size of token.aleo/transfer: k = 4
    transitions with different amounts in both MSM modes, then k = 8 once."""
    t0 = time.time()
    reg = load_example("simple_token")
    if keys is None:
        keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
    assert (keys.index.n, keys.index.m) == (8192, 32768), (keys.index.n, keys.index.m)
    syns = [pipeline.synthesize_and_check(keys, reg, transfer_inputs(100 + i), SENDER,
                                          lambda: RNG_NONCE) for i in range(BATCH_K_ONCE)]
    assert len({tuple(s.public_inputs) for s in syns}) == BATCH_K_ONCE
    cs4 = [s.cs for s in syns[:BATCH_K]]
    dims = (keys.index.n, keys.index.m, keys.index.ell)
    runs = {}
    assert config.MSM_AFFINE_MODE == "1"
    try:
        for mode, name in (("1", "affine"), ("0", "projective")):
            config.MSM_AFFINE_MODE = mode
            proofs, seconds, launches, ntts, stages, peak = _prove_batch_timed(keys, cs4)
            runs[name] = {"proofs": proofs, "seconds": seconds,
                          "seconds_per_proof": seconds / BATCH_K, "launches": launches,
                          "batched_transforms": ntts, "stages": stages,
                          "peak_device_bytes": peak}
            mine = AFFINE_KERNELS if mode == "1" else PROJECTIVE_KERNELS
            other = PROJECTIVE_KERNELS if mode == "1" else AFFINE_KERNELS
            for kname in mine + ("g1_normalize", "fmat_reduce"):
                assert launches[kname] > 0, f"{kname} was never launched in the {name} batch"
            for kname in other + ("fq_mul",):
                assert launches[kname] == 0, f"{kname} was launched in the {name} batch"
            assert ntts["matntt"] > 0, "no batched transform ran as MatNTT"
        faster = min(runs, key=lambda nm: runs[nm]["seconds"])
        config.MSM_AFFINE_MODE = "1" if faster == "affine" else "0"
        proofs8, seconds8, launches8, ntts8, _, peak8 = _prove_batch_timed(
            keys, [s.cs for s in syns])
    finally:
        config.MSM_AFFINE_MODE = "1"

    t1 = time.time()
    for s, proof in zip(syns, runs["affine"]["proofs"]):
        assert verify(keys.vk, s.public_inputs, proof), "a batch proof does not verify"
    assert not verify(keys.vk, syns[1].public_inputs, runs["affine"]["proofs"][0]), \
        "proof 0 was accepted under proof 1's public inputs"
    as_bytes = lambda proofs: [proof_to_bytes(p, *dims) for p in proofs]
    assert as_bytes(runs["projective"]["proofs"]) == as_bytes(runs["affine"]["proofs"]), \
        "the projective batch's bytes differ from the affine batch's"
    assert len(set(as_bytes(runs["affine"]["proofs"]))) == BATCH_K
    # both modes' four proofs against the JAX package's prove_batch
    t2 = time.time()
    want = JAX["batch"]["proofs"]
    held("batch", [[str(v) for v in s.public_inputs] for s in syns[:BATCH_K]]
         == [w["public_inputs"] for w in want], "the public inputs")
    for name, r in runs.items():
        held("batch", [b.hex() for b in as_bytes(r["proofs"])] == [w["proof"] for w in want],
             f"the {name} batch's proofs")
    vectors_s = time.time() - t2
    # k = 8 under the same seed: its first masks are drawn for eight proofs,
    # so these are other proofs than the four above; the first and the last
    # are verified (a verification is seconds of host pairing work)
    for i in (0, BATCH_K_ONCE - 1):
        assert verify(keys.vk, syns[i].public_inputs, proofs8[i]), \
            f"proof {i} of the k = 8 batch does not verify"
    verify_s = time.time() - t1
    for r in runs.values():
        del r["proofs"]
    say({"phase": "batch", "k": BATCH_K, "n": keys.index.n, "m": keys.index.m,
         "single_prove_seconds": single_s, **runs, "bytes_equal": True,
         "jax_vectors": {"batch": True}, "jax_vectors_seconds": vectors_s,
         "k8": {"k": BATCH_K_ONCE, "mode": faster, "seconds": seconds8,
                "seconds_per_proof": seconds8 / BATCH_K_ONCE, "launches": launches8,
                "batched_transforms": ntts8, "peak_device_bytes": peak8},
         "verify_seconds": verify_s, "proofs_verified": BATCH_K + 2,
         "seconds": round(time.time() - t0, 3)})
    # each kernel's count on the batch path that runs it
    return {**runs["affine"]["launches"],
            **{k: runs["projective"]["launches"][k] for k in PROJECTIVE_KERNELS}}


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _prove_transfer_timed(keys, reg):
    """One seeded transfer proof, as phase transfer proves it, with every
    count set to 0 just before and read just after -> (proof, seconds,
    launches, stage timers)."""
    reset_launches()
    prof.reset()
    prof.enable()
    try:
        ep, seconds = _timed(lambda: pipeline.prove_execution(
            keys, reg, transfer_inputs(TRANSFER_AMOUNT), caller=SENDER,
            rng_nonce=lambda: RNG_NONCE, rng=random.Random(SEED)))
        return ep, seconds, all_launches(), prof.report()
    finally:
        prof.enable(False)


def phase_fixed_base(srs, keys):
    """The fixed-base MSM (msm/fixed_base.py) and kzg's fixed-base branches,
    off by default, at full size: (a) the table of the first 32768 SRS
    powers at c = 13, and batch_inv_lf and fq_mul at its 655,360 lanes;
    (b) fixed-base MSMs at 2^12 and 2^15 points against the variable-base
    ones in both modes; (c) F1's commit group (k = 4, n = 32767, shift = 3);
    (d) a transfer proof with the mode "auto" against the default proof.
    The host Pippenger oracles run in worker processes beside the card's
    work. Every agreement is printed before the phase fails on one."""
    t0 = time.time()
    rng = random.Random(SEED + 20)
    assert config.FIXED_BASE_MODE == "0", "the fixed-base MSM must be off by default"
    host = srs.host_affine()
    pw = srs.powers
    c = fixed_base.DEFAULT_C
    W = fixed_base._nwin(c)
    agrees = {}
    oracles = {}                        # name -> (future of the host's point, the card's)
    fixed_base.clear_cache()
    pool = ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    try:
        # (a) the table, and the two kernels of its normalization at its width
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ft, build_s = _timed(lambda: fixed_base.srs_table(srs, FB_N, 0))
        build_launches = _nonzero(all_launches())
        assert W == 20 and ft.rows.shape == (W * FB_N, 2 * L), ft.rows.shape
        assert build_launches == {"g1_double": (W - 1) * c, "fq_inv_up": 2, "fq_fermat": 1,
                                  "fq_inv_down": 2, "fq_mul": 2}, build_launches
        pts = sorted({0, FB_N - 1, *rng.sample(range(FB_N), FB_ROW_POINTS - 2)})
        ids = torch.tensor([w * FB_N + i for i in pts for w in range(W)], device=DEV)
        sample = limbs.to_numpy(ft.rows[ids])
        assert all(v < Q for v in limbs.limbs_to_ints(sample.reshape(-1, L))), \
            "a table row is not canonical"
        xs = limbs.from_mont_host(sample[:, :L], Q)
        ys = limbs.from_mont_host(sample[:, L:], Q)
        j = 0
        for i in pts:
            q = host[i]
            for w in range(W):          # row w * N + i holds 2^(13 w) P_i
                assert (xs[j], ys[j]) == q, f"table row {w * FB_N + i} disagrees with the host"
                j += 1
                for _ in range(c):
                    q = G1.double(q)
        m = W * FB_N
        g = torch.Generator(device=DEV)
        g.manual_seed(SEED + 21)
        d = torch.randint(0, 1 << 16, (L, m), dtype=torch.int32, device=DEV, generator=g)
        d[L - 1] %= 0x35C                                   # below 2p
        d[:, : len(INV_EDGE)] = fq_tensor(INV_EDGE)
        assert not lk.is_zero_mod_p(lk.get_fq(), d).any()
        reset_launches()
        inv = ga.batch_inv_lf(d)
        inv_launches = _nonzero(all_launches())
        assert inv_launches == {"fq_inv_up": 2, "fq_fermat": 1, "fq_inv_down": 2}, inv_launches
        prod = ga._mul_plain(d, inv)
        assert torch.equal(norm(prod), ga._one_mont(DEV).expand(L, m)), \
            f"batch_inv_lf is wrong at {m} lanes"
        assert torch.equal(ga.fq_mul(d, inv), prod), \
            f"fq_mul disagrees with its plain version at {m} lanes"
        del d, inv, prod
        table = {"seconds": build_s, "launches": build_launches, "rows": W * FB_N,
                 "bytes": fixed_base.cached_bytes(), "rows_checked": j,
                 "peak_device_bytes": torch.cuda.max_memory_allocated(),
                 "batch_inv_lf_and_fq_mul_lanes": m, "batch_inv_lf_launches": inv_launches}

        # (b) fixed-base against variable-base MSMs, and the host
        msms = {}
        for n in FB_SIZES:
            tf = fixed_base.srs_table(srs, n, 0)
            tv = msm_mod.make_table(g1mod.G1Points(pw.x[:n], pw.y[:n], pw.z[:n]))
            raw = random_fr(FB_K * n, SEED + 22 + n).T.reshape(FB_K, n, params.FR_LIMBS)
            raw = raw.contiguous()
            single = lambda: fixed_base.msm_fixed_host(raw[0], tf)
            batch = lambda: fixed_base.msm_fixed_batch_host(raw, tf)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            one_pt, single_first_s = _timed(single)
            single_launches = _nonzero(all_launches())
            reset_launches()
            pts4, batch_first_s = _timed(batch)
            batch_launches = _nonzero(all_launches())
            _, single_s = _timed(single)
            _, batch_s = _timed(batch)
            for kname in AFFINE_KERNELS + ("g1_add", "g1_double", "g1_normalize"):
                assert batch_launches.get(kname, 0) > 0, f"{kname} not launched by the fixed MSM"
            assert "fq_mul" not in batch_launches, "a cached table was built again"
            row = {"fixed_seconds": single_s, "fixed_first_seconds": single_first_s,
                   "fixed_batch_seconds": batch_s, "fixed_batch_first_seconds": batch_first_s,
                   "fixed_launches": single_launches, "fixed_batch_launches": batch_launches,
                   "peak_device_bytes": torch.cuda.max_memory_allocated()}
            same_pts = pts4[0] == one_pt
            try:
                for mode, name in (("1", "affine"), ("0", "projective")):
                    config.MSM_AFFINE_MODE = mode
                    var1 = lambda: msm_mod.msm_fast_host(raw[0], tv)
                    var4 = lambda: [msm_mod.msm_fast_host(raw[p], tv) for p in range(FB_K)]
                    _timed(var1)
                    _, var1_s = _timed(var1)
                    want, var4_s = _timed(var4)
                    same_pts = same_pts and pts4 == want
                    row[f"variable_{name}_seconds"] = var1_s
                    row[f"variable_{name}_four_seconds"] = var4_s
            finally:
                config.MSM_AFFINE_MODE = "1"
            agrees[f"msm_{n}_fixed_equals_variable"] = same_pts
            oracles[f"msm_{n}_member0"] = (pool.submit(
                msm_pippenger_jac, limbs.limbs_to_ints(limbs.to_numpy(raw[0])), host[:n],
                FB_ORACLE_C), one_pt)
            msms[str(n)] = row

        # (c) F1's shape: k = 4 polynomials of 32767 coefficients at shift 3
        # over the 32770 powers, so n_pad clamps to 32767 and s = 2
        assert kzg._pad_size(srs, F1_N, F1_SHIFT) == F1_N
        s_f1 = fixed_base._sub_split(c, F1_N, F1_K)
        assert s_f1 == 2
        polys = [random_fr(F1_N, SEED + 30 + i) for i in range(F1_K)]
        try:
            config.FIXED_BASE_MODE = "1"
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            f1_fixed, f1_first_s = _timed(lambda: kzg.commit_many_lf(srs, polys, shift=F1_SHIFT))
            f1_launches = _nonzero(all_launches())
            _, f1_s = _timed(lambda: kzg.commit_many_lf(srs, polys, shift=F1_SHIFT))
            f1_peak = torch.cuda.max_memory_allocated()
        finally:
            config.FIXED_BASE_MODE = "0"
        f1_var, f1_var_s = _timed(lambda: kzg.commit_many_lf(srs, polys, shift=F1_SHIFT))
        agrees["f1_fixed_equals_variable"] = f1_fixed == f1_var
        oracles["f1_member0"] = (pool.submit(
            msm_pippenger_jac, lf.decode(polys[0]), host[F1_SHIFT : F1_SHIFT + F1_N],
            FB_ORACLE_C), f1_fixed[0])
        f1 = {"n": F1_N, "k": F1_K, "shift": F1_SHIFT, "c": c, "windows": W,
              "sub_split": s_f1, "fixed_seconds": f1_s, "fixed_first_seconds": f1_first_s,
              "fixed_first_launches": f1_launches, "variable_seconds": f1_var_s,
              "peak_device_bytes": f1_peak}

        # (d) a transfer proof with the mode "auto", beside the default one,
        # tables built by the first of the two
        reg = load_example("simple_token")
        if keys is None:
            keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
        dims = (keys.index.n, keys.index.m, keys.index.ell)
        fixed_base.clear_cache()
        ep0, default_s, default_launches, default_stages = _prove_transfer_timed(keys, reg)
        default_bytes = proof_to_bytes(ep0.proof, *dims)
        auto = {}
        try:
            config.FIXED_BASE_MODE = "auto"
            for run in ("tables_built", "tables_cached"):
                ep, secs, launches, stages = _prove_transfer_timed(keys, reg)
                auto_bytes = proof_to_bytes(ep.proof, *dims)
                agrees[f"auto_proof_{run}_bytes_equal"] = auto_bytes == default_bytes
                agrees[f"auto_proof_{run}_is_the_jax_proof"] = \
                    auto_bytes.hex() == JAX["transfer"]["proof"]
                auto[run] = {"prove_seconds": secs, "launches": launches,
                             "kzg_commit_seconds": stages["kzg/commit"]["seconds"],
                             "stages": stages}
        finally:
            config.FIXED_BASE_MODE = "0"
        agrees["auto_proof_verifies"] = pipeline.verify_execution(keys, ep, debug=True)
        for kname in AFFINE_KERNELS + ("fq_mul", "g1_double", "g1_add", "g1_normalize"):
            assert auto["tables_built"]["launches"][kname] > 0, \
                f"{kname} was never launched during the auto proof"
        proof = {"default": {"prove_seconds": default_s, "launches": default_launches,
                             "kzg_commit_seconds": default_stages["kzg/commit"]["seconds"]},
                 **auto, "tables": sorted(k[2:4] for k in fixed_base._CACHE),
                 "tables_bytes": fixed_base.cached_bytes()}

        for name, (fut, pt) in oracles.items():
            agrees[f"{name}_equals_host_pippenger"] = fut.result() == pt
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        fixed_base.clear_cache()
    agrees["f1_shape_agrees"] = (agrees["f1_fixed_equals_variable"]
                                 and agrees["f1_member0_equals_host_pippenger"])
    say({"phase": "fixed_base", "f1_shape_agrees": agrees["f1_shape_agrees"],
         "jax_vectors": {"transfer": agrees["auto_proof_tables_built_is_the_jax_proof"]
                         and agrees["auto_proof_tables_cached_is_the_jax_proof"]},
         "agrees": agrees, "table": table, "msm": msms, "f1": f1, "proof": proof,
         "seconds": round(time.time() - t0, 3)})
    failed = [k for k, v in agrees.items() if not v]
    assert not failed, f"fixed_base: disagreement in {failed}"
    return auto["tables_built"]["launches"]


# ---------------------------------------------------------------------------
# the limbs-last device API and the record scan


def _sample(rng, n, k=SAMPLE):
    return sorted(rng.sample(range(n), k))


def _canonical(ring, t):
    """Every lane of an (..., L) limbs-last tensor is < p (normalize, which
    changes any value >= p, leaves it alone)."""
    lf_t = t.reshape(-1, ring.L).T
    return torch.equal(lk.normalize(ring.limb_ring, lf_t), lf_t)


def _ring_checks(ring, rng, vec):
    """mul, add, sub, neg, batch_inv, inv of one ring at LL_LANES lanes
    against host integers on SAMPLE lanes; zero lanes planted for inv. The
    digests of the inputs and of every output (canonical values, 2L bytes
    each) go into `vec`, to be held against the JAX package's."""
    p, n, width = ring.p, LL_LANES, 2 * ring.L
    xs = [rng.randrange(1, p) for _ in range(n)]
    ys = [rng.randrange(p) for _ in range(n)]
    xs[:4] = [1, p - 1, 2, p - 2]
    ys[:4] = [0, p - 1, p - 1, 1]
    zs = list(xs)
    for i in (5, n // 2, n - 1):
        zs[i] = 0
    vec["inputs"][ring.name] = sha256(int_bytes(xs + ys + zs, width))
    vec[ring.name] = {}
    a, b, z = (ring.encode(v, device=DEV) for v in (xs, ys, zs))
    idx = _sample(rng, n) + [0, 1, 2, 3, 5, n // 2, n - 1]
    want = {
        "mul": lambda i: xs[i] * ys[i] % p, "add": lambda i: (xs[i] + ys[i]) % p,
        "sub": lambda i: (xs[i] - ys[i]) % p, "neg": lambda i: -xs[i] % p,
        "batch_inv": lambda i: pow(xs[i], -1, p), "inv": lambda i: pow(zs[i], p - 2, p),
    }
    calls = {
        "mul": lambda: ring.mul(a, b), "add": lambda: ring.add(a, b),
        "sub": lambda: ring.sub(a, b), "neg": lambda: ring.neg(a),
        "batch_inv": lambda: ring.batch_inv(a), "inv": lambda: ring.inv(z),
    }
    out = {}
    for op, fn in calls.items():
        got, s = _timed(fn)
        assert got.shape == (n, ring.L), f"{ring.name}.{op}: shape {tuple(got.shape)}"
        assert _canonical(ring, got), f"{ring.name}.{op}: a lane is not canonical"
        vals = ring.decode(got[idx])
        assert [int(v) for v in vals] == [want[op](i) for i in idx], f"{ring.name}.{op} wrong"
        out[op + "_s"] = s
        vec[ring.name][op] = sha256(int_bytes(ring.decode(got).tolist(), width))
    assert ring.decode(ring.inv(z)[[5, n // 2, n - 1]]).tolist() == [0, 0, 0]
    return out, a, b


def phase_limbs_last(srs):
    """The limbs-last device API at the sizes of a transfer proof."""
    t0 = time.time()
    rng = random.Random(SEED + 10)
    reset_launches()
    res = {}
    # digests of the inputs and outputs, held against the vector file's
    # limbs_last entry at the end (the inputs first)
    vec = {"inputs": {}}
    fr_sha = lambda t: sha256(int_bytes(FR_RING.decode(t).tolist()))
    # -- ModRing, both rings; FR_RING.mul beside fr_lf.mul on the same values
    res["Fq"] = _ring_checks(FQ_RING, rng, vec)[0]
    res["Fr"], a, b = _ring_checks(FR_RING, rng, vec)
    alf, blf = a.T.contiguous(), b.T.contiguous()
    assert torch.equal(FR_RING.mul(a, b), lf.normalize(lf.mul(alf, blf)).T)
    res["Fr"]["mul_ms"] = cuda_ms(lambda: FR_RING.mul(a, b), 10)
    res["Fr"]["fr_lf_mul_ms"] = cuda_ms(lambda: lf.mul(alf, blf), 10)

    # -- coset NTT at 2^16: round trip, one evaluation against host Horner
    shift = params.FR_GENERATOR
    coeffs = [rng.randrange(R) for _ in range(LL_LANES)]
    vec["inputs"]["coeffs"] = sha256(int_bytes(coeffs))
    x = FR_RING.encode(coeffs, device=DEV)
    ev, res["coset_ntt_s"] = _timed(lambda: dntt.coset_ntt(x, shift))
    vec["coset_ntt"] = fr_sha(ev)
    back, res["coset_intt_s"] = _timed(lambda: dntt.coset_intt(ev, shift))
    assert torch.equal(back, x), "coset_intt(coset_ntt(x)) != x"
    i = rng.randrange(LL_LANES)
    pt = shift * pow(dntt.domain(LL_LANES).w, i, R) % R
    assert FR_RING.decode(ev[i]) == rpoly.evaluate(coeffs, pt), "coset_ntt wrong"

    # -- eval_coeffs and divide_by_linear_via_domain at |K| coefficients
    m = LL_M
    pc = coeffs[:m]
    pdev = x[:m]
    z = rng.randrange(R)
    zd = FR_RING.const(z, device=DEV)
    y, res["eval_coeffs_s"] = _timed(lambda: pd.eval_coeffs(pdev, zd))
    assert FR_RING.decode(y) == rpoly.evaluate(pc, z), "eval_coeffs wrong"
    vec["eval_coeffs"] = str(FR_RING.decode(y))
    (q, y2), res["divide_by_linear_s"] = _timed(lambda: pd.divide_by_linear_via_domain(pdev, zd))
    vec["divide_by_linear"] = {"q": fr_sha(q), "y": str(FR_RING.decode(y2))}
    xr = rng.randrange(R)
    qv = rpoly.evaluate([int(v) for v in FR_RING.decode(q)], xr)
    assert (qv * (xr - z) + FR_RING.decode(y2) - rpoly.evaluate(pc, xr)) % R == 0, \
        "q(x)(x - z) + y != p(x)"

    # -- poly_mul of two 16384-coefficient polynomials
    ha, hb = coeffs[: LL_MUL], coeffs[LL_MUL : 2 * LL_MUL]
    prod, res["poly_mul_s"] = _timed(lambda: pd.poly_mul(x[:LL_MUL], x[LL_MUL : 2 * LL_MUL]))
    assert prod.shape == (2 * LL_MUL - 1, FR_RING.L)
    vec["poly_mul"] = fr_sha(prod)
    xr = rng.randrange(R)
    assert rpoly.evaluate([int(v) for v in FR_RING.decode(prod)], xr) == \
        rpoly.evaluate(ha, xr) * rpoly.evaluate(hb, xr) % R, "poly_mul wrong"

    # -- divide_by_vanishing of 40960 coefficients by n = |H|
    vc = [rng.randrange(R) for _ in range(LL_VANISH)]
    vec["inputs"]["vanish"] = sha256(int_bytes(vc))
    (vq, vr), res["divide_by_vanishing_s"] = _timed(
        lambda: pd.divide_by_vanishing(FR_RING.encode(vc, device=DEV), LL_N))
    vec["divide_by_vanishing"] = {"q": fr_sha(vq), "r": fr_sha(vr)}
    xr = rng.randrange(R)
    lhs = (rpoly.evaluate([int(v) for v in FR_RING.decode(vq)], xr) * (pow(xr, LL_N, R) - 1)
           + rpoly.evaluate([int(v) for v in FR_RING.decode(vr)], xr)) % R
    assert lhs == rpoly.evaluate(vc, xr), "q(x) v_H(x) + r(x) != a(x)"

    # -- commits of |K| coefficients: device combine, host combine, commit_lf
    (cm_dev, res["commit_s"]) = _timed(lambda: kzg.commit(srs, pdev))
    cm_host, res["commit_host_s"] = _timed(lambda: kzg.commit_host(srs, pdev))
    cm_lf, res["commit_lf_s"] = _timed(lambda: kzg.commit_lf(srs, pdev.T.contiguous()))
    cm_pt = g1mod.decode_points(cm_dev)[0]
    assert cm_pt == cm_host == cm_lf, "limbs-last commits disagree"
    vec["commit"] = {"point": point_to_bytes(cm_pt).hex()}

    # -- open_at and batch_open_at over LL_OPEN polynomials of |H| coefficients
    polys_h = [[rng.randrange(R) for _ in range(LL_N)] for _ in range(LL_OPEN)]
    vec["inputs"]["open"] = sha256(int_bytes(v for p_ in polys_h for v in p_))
    polys = [FR_RING.encode(v, device=DEV) for v in polys_h]
    (w, yo), res["open_at_s"] = _timed(lambda: kzg.open_at(srs, polys[0], zd))
    yv = FR_RING.decode(yo)
    vec["open_at"] = {"w": point_to_bytes(w).hex(), "y": str(yv)}
    cm0 = kzg.commit_host(srs, polys[0])
    assert yv == rpoly.evaluate(polys_h[0], z)
    assert kzg.verify(srs, cm0, z, yv, w), "open_at does not verify"
    assert not kzg.verify(srs, cm0, z, (yv + 1) % R, w), "tampered y verifies"
    gamma = rng.randrange(R)
    (wb, ys), res["batch_open_at_s"] = _timed(
        lambda: kzg.batch_open_at(srs, polys, zd, FR_RING.const(gamma, device=DEV)))
    ys = [FR_RING.decode(v) for v in ys]
    vec["inputs"]["z_gamma"] = sha256(int_bytes([z, gamma]))
    vec["batch_open_at"] = {"w": point_to_bytes(wb).hex(), "ys": [str(v) for v in ys]}
    cms = [cm0] + [kzg.commit_host(srs, p_) for p_ in polys[1:]]
    assert kzg.batch_verify(srs, cms, z, ys, gamma, wb), "batch_open_at does not verify"
    assert not kzg.batch_verify(srs, cms, z, [(ys[0] + 1) % R] + ys[1:], gamma, wb), \
        "tampered batch verifies"

    # -- the universal SRS blob: bytes -> blob -> to_srs() with no device
    t1 = time.time()
    blob = UniversalSrsBlob(LL_SRS_POWERS - 1, srs.host_affine()[:LL_SRS_POWERS],
                            srs.g2_gen, srs.g2_tau)
    data = blob.to_bytes()
    back = UniversalSrsBlob.from_bytes(data)
    imported = back.to_srs()
    assert imported.device.type == DEV.type, f"to_srs() landed on {imported.device}"
    for k in "xyz":
        assert torch.equal(getattr(imported.powers, k),
                           getattr(srs.powers, k)[:LL_SRS_POWERS]), f"imported powers.{k}"
    res["srs_blob"] = {"powers": LL_SRS_POWERS, "bytes": len(data), "seconds": time.time() - t1}
    torch.cuda.synchronize()
    launches = _nonzero(all_launches())
    for kname in ("fmat_reduce", "fq_prepare", "fq_apply", "g1_double", "g1_add"):
        assert launches.get(kname, 0) > 0, f"{kname} was never launched by limbs_last"
    # the inputs' digests first (a drift of the draws fails here), then
    # every output against the JAX package's
    t1 = time.time()
    want = JAX["limbs_last"]
    held("limbs_last", vec.pop("inputs") == want["inputs"]["input_sha256"], "the inputs")
    for name, got in vec.items():
        if isinstance(got, dict):
            held("limbs_last", got == {k: want[name][k] for k in got}, name)
        else:
            held("limbs_last", got == want[name], name)
    say({"phase": "limbs_last", "lanes": LL_LANES, "m": LL_M, "n": LL_N, **res,
         "jax_vectors": {"limbs_last": True}, "jax_vectors_seconds": time.time() - t1,
         "launches": launches, "seconds": round(time.time() - t0, 3)})
    return launches


def _ladder_step_launches(xs, ys):
    """CUDA kernel launches of one ladder step (a doubling, an addition and
    the select) at the phase's width, from torch.profiler; None where the
    profiler shows no device rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        ed.scalar_mul_batch([1], xs, ys)
        torch.cuda.synchronize()
    rows = [ev for ev in p.key_averages()
            if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return sum(ev.count for ev in rows) or None


def _f5_point(rng):
    """An off-curve point P with 1 + d*t = 0 in add(2P, P): for a random u,
    s = (d^2 u^4 - 1) / (2 d u^2), and x^2, y^2 the roots of z^2 - s z + u^2
    with x y = u."""
    D = params.EDWARDS_D
    while True:
        u = rng.randrange(1, R)
        s = (D * D * pow(u, 4, R) - 1) * pow(2 * D * u * u, -1, R) % R
        disc = (s * s - 4 * u * u) % R
        if not FR.is_square(disc):
            continue
        x2 = (s + FR.sqrt(disc)) * pow(2, -1, R) % R
        if x2 == 0 or not FR.is_square(x2):
            continue
        x = FR.sqrt(x2)
        P = (x, u * pow(x, -1, R) % R)
        assert not edwards.is_on_curve(P)
        return P


def phase_record_scan():
    """A wallet's record scan at full width: Poseidon hashing of records and
    the view-key ECDH over a block of ciphertexts."""
    t0 = time.time()
    rng = random.Random(SEED + 11)
    reset_launches()
    res = {}
    vectors_s = 0.0
    # -- Poseidon at rates 2, 4, 8: hash_batch over B rows of 4, permute
    for rate in (2, 4, 8):
        rows = [[rng.randrange(R) for _ in range(RS_INPUTS)] for _ in range(RS_ROWS)]
        want = JAX["poseidon"]
        held("poseidon", sha256(int_bytes(v for r in rows for v in r))
             == want["inputs"]["rows_sha256"][str(rate)], f"the rows at rate {rate}")
        enc = FR_RING.encode([v for r in rows for v in r], device=DEV).reshape(
            RS_ROWS, RS_INPUTS, FR_RING.L)
        out, hs = _timed(lambda: poseidon.hash_batch(rate, enc))
        # every row's hash against the JAX package's hash_batch
        t1 = time.time()
        held("poseidon", sha256(int_bytes(FR_RING.decode(out).tolist())) == want["sha256"][str(rate)],
             f"hash_batch at rate {rate} over {RS_ROWS} rows")
        vectors_s += time.time() - t1
        idx = _sample(rng, RS_ROWS, RS_HASH_CHECKED)
        assert FR_RING.decode(out[idx]).tolist() == [ref_poseidon.hash_psd(rate, rows[i]) for i in idx], \
            f"hash_batch at rate {rate} wrong"
        states = [[rng.randrange(R) for _ in range(rate + 1)] for _ in range(RS_ROWS)]
        st = FR_RING.encode([v for s in states for v in s], device=DEV).reshape(
            RS_ROWS, rate + 1, FR_RING.L)
        perm, ps = _timed(lambda: poseidon.permute(st, rate))
        pp = ref_poseidon.PoseidonParams.standard(rate)
        for i in idx:
            assert FR_RING.decode(perm[i]).tolist() == ref_poseidon.permute(states[i], pp), \
                f"permute at rate {rate} wrong in row {i}"
        res[f"rate{rate}"] = {"hash_batch_s": hs, "permute_s": ps}

    # -- the view-key ECDH over RS_POINTS ephemeral points, one of them off
    # the curve and built so that the ladder's second step meets a zero
    # denominator (F5): a 250-bit view scalar (the group order is below
    # 2^250 + 2^249, so no 251-bit one has its second-highest bit set) with
    # its top two bits set, even, so the host's ladder (low bit first) does
    # not meet it
    view = rng.randrange(3 << 248, 1 << 250) & ~1
    P, Q = edwards.rand(rng), edwards.rand(rng)
    pts = [P]
    for _ in range(RS_POINTS - 1):
        pts.append(edwards.add(pts[-1], Q))
    planted = rng.randrange(RS_POINTS)
    pts[planted] = _f5_point(rng)
    want = JAX["ecdh"]
    drawn = sha256(int_bytes([view] + [c for p in pts for c in p]))
    held("ecdh", (planted, drawn) == (want["inputs"]["planted"], want["inputs"]["input_sha256"]),
         "the view scalar and the points")
    xs, ys = ed.encode_points(pts, device=DEV)
    step_launches = _ladder_step_launches(xs, ys)
    got, es = _timed(lambda: ed.shared_secrets(view, pts))
    idx = sorted(set(_sample(rng, RS_POINTS, RS_ECDH_CHECKED)) | {planted})
    assert [got[i] for i in idx] == [edwards.mul(view, pts[i]) for i in idx], "shared_secrets wrong"
    # every on-curve lane (all but the planted one) against the JAX
    # package's ladder over the same lanes in the same order
    t1 = time.time()
    lanes = [i for i in range(RS_POINTS) if i != planted][:RS_ECDH_LANES]
    held("ecdh", sha256(int_bytes(c for i in lanes for c in got[i])) == want["sha256"],
         f"shared_secrets over {len(lanes)} on-curve lanes")
    held("ecdh", [[i, str(got[i][0]), str(got[i][1])] for i, _, _ in want["samples"]]
         == want["samples"], "the sampled lanes")
    vectors_s += time.time() - t1
    res["ecdh"] = {"points": RS_POINTS, "off_curve_lane": planted, "lanes_checked": len(idx),
                   "lanes_held": len(lanes),
                   "view_bits": view.bit_length(), "seconds": es,
                   "ladder_steps": view.bit_length(), "batch_inv_readbacks": 4 * view.bit_length(),
                   "launches_per_step": step_launches}
    torch.cuda.synchronize()
    say({"phase": "record_scan", "rows": RS_ROWS, **res,
         "jax_vectors": {"poseidon": True, "ecdh": True}, "jax_vectors_seconds": vectors_s,
         "launches": _nonzero(all_launches()), "seconds": round(time.time() - t0, 3)})


def _launches_of(fn):
    """fn() with every count set to 0 just before and read just after ->
    (result, seconds, launches)."""
    reset_launches()
    out, seconds = _timed(fn)
    return out, seconds, all_launches()


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_mesh(srs, keys):
    """parallel/mesh.py, prove_batch(mesh=...) and graft_entry at full width
    in a world of one under NCCL, mesh (1, 1): one card, so the butterfly
    runs no step and the all-to-all moves one block; no exchange between
    cards is verified here (the CPU tests run them over gloo ranks). Each
    sharded call runs with the counts set to 0 just before and read just
    after; the unsharded calls it is held against are not counted."""
    t0 = time.time()
    rng = random.Random(SEED + 30)
    path, checks = {}, {}

    def check(name, sharded, unsharded=None):
        """sharded() counted, then unsharded(), then each once more: the
        seconds of the first and the second calls, in turns."""
        out, s1, launches = _launches_of(sharded)
        _add_launches(path, launches)
        checks[name] = {"seconds": [s1], "launches": _nonzero(launches)}
        if unsharded is None:
            return out, None
        want, u1 = _timed(unsharded)
        s2, u2 = _timed(sharded)[1], _timed(unsharded)[1]
        checks[name].update(seconds=[s1, s2], unsharded_seconds=[u1, u2])
        return out, want

    init_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    pmesh.init_distributed(f"file://{init_dir}/init", 1, 0, timeout=300)
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = pmesh.make_mesh(1, 1)
        # (a) the MSM over a transfer proof's m points, both modes
        pts = g1mod.G1Points(*(a[:MESH_POINTS] for a in srs.powers))
        raw = limbs.to_tensor(limbs.ints_to_limbs(
            [rng.randrange(R) for _ in range(MESH_POINTS)], params.FR_LIMBS), DEV)
        assert config.MSM_AFFINE_MODE == "1"
        try:
            for mode, name in (("1", "affine"), ("0", "projective")):
                config.MSM_AFFINE_MODE = mode
                got, want = check(f"sharded_msm_{name}",
                                  lambda: pmesh.sharded_msm(mesh, raw, pts),
                                  lambda: msm_mod.msm(raw, pts, device=DEV))
                assert g1mod.decode_points(got) == g1mod.decode_points(want), \
                    f"sharded_msm ({name}) disagrees with msm.msm"
        finally:
            config.MSM_AFFINE_MODE = "1"
        # (b) the 4-step NTT at 2^17, local transforms on MatNTT
        n1, n2 = MESH_NTT
        x = FR_RING.encode([rng.randrange(R) for _ in range(n1 * n2)], device=DEV)
        got, want = check("sharded_ntt", lambda: pmesh.sharded_ntt(mesh, x, n1, n2, impl="matntt"),
                          lambda: dntt.ntt(x))
        assert torch.equal(got, want), "sharded_ntt disagrees with ntt.ntt"
        # (c) a transfer batch of four over the dp axis
        reg = load_example("simple_token")
        if keys is None:
            keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
        syns = [pipeline.synthesize_and_check(keys, reg, transfer_inputs(100 + i), SENDER,
                                              lambda: 11) for i in range(BATCH_K)]
        cs4 = [syn.cs for syn in syns]
        proofs, plain = check(
            "prove_batch_mesh",
            lambda: batch_mod.prove_batch(keys.index, cs4, rng=random.Random(SEED), mesh=mesh),
            lambda: batch_mod.prove_batch(keys.index, cs4, rng=random.Random(SEED)))
        dims = (keys.index.n, keys.index.m, keys.index.ell)
        assert [proof_to_bytes(p, *dims) for p in proofs] == \
            [proof_to_bytes(p, *dims) for p in plain], "the sharded batch's bytes differ"
        assert verify(keys.vk, syns[0].public_inputs, proofs[0]), "a sharded batch proof does not verify"
        # (d) the entry step against the host: the round's evaluations, the MSM
        step, args = graft_entry.entry()
        (h, ax, ay, az), _ = check("graft_entry", lambda: step(*args))
        zs = [int(v) for v in FR_RING.decode(args[0])]
        ev = rpoly.coset_ntt(rpoly.ntt(zs, invert=True) + [0] * len(zs), params.FR_GENERATOR)
        assert [int(v) for v in FR_RING.decode(h)] == [v * v % R for v in ev], "entry: h"
        sc = [int(v) for v in limbs.limbs_to_ints(limbs.to_numpy(args[1]))]
        assert g1mod.decode_points(g1mod.G1Points(ax, ay, az)) == \
            [msm_pippenger_jac(sc, graft_entry._gen_points(len(sc)))], "entry: the MSM"
        # (e) the dry run, which checks itself against the host
        check("dryrun_multichip", lambda: graft_entry.dryrun_multichip(1))
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(init_dir, ignore_errors=True)
    for k in MESH_KERNELS:
        assert path.get(k, 0) > 0, f"{k} was never launched in the mesh phase"
    torch.cuda.synchronize()
    say({"phase": "mesh", "world": 1, "mesh": [1, 1], "backend": "nccl", "cards": 1,
         "exchanges_verified_on_cards": False, "msm_points": MESH_POINTS,
         "ntt": list(MESH_NTT), "batch_k": BATCH_K, **checks,
         "launches": _nonzero(path), "seconds": round(time.time() - t0, 3)})
    return path


def phase_sdk():
    """The host SDK at full width on the card: a verifying ledger, a proved
    token.aleo/transfer through ProgramManager (its keys synthesized by the
    pipeline over the cached SRS), accepted by the ledger; a tampered copy
    refused; a wallet scan of SDK_RECORDS credits ciphertexts through the
    device ECDH, equal to the per-record host scan. The counts are set to 0
    at the start and read after the batched scan."""
    t0 = time.time()
    reset_launches()
    ledger = Ledger(verify_proofs=True)
    alice, bob = PrivateKey(seed=SEED), PrivateKey(seed=SEED + 1)
    ledger.genesis_mint(alice.address().to_string(), SDK_RECORDS * 1_000_000,
                        n_records=SDK_RECORDS)
    token = load_program("simple_token")
    ledger.program_sources[token.id] = token.source
    ledger.registry.add(token)
    client = LocalAPIClient(ledger)
    pm = ProgramManager(client, private_key=alice)
    pm.add_program(token.source)
    rec = Record("token.aleo", "token", owner=alice.address().x, gates=0,
                 entries={"amount": Value("u64", 500)}, nonce=7)
    inputs = [rec, Value("address", bob.address().x), Value("u64", 120)]
    t1 = time.time()
    tx_id = pm.execute_program("token.aleo", "transfer", inputs, prove=True)
    torch.cuda.synchronize()
    execute_s = time.time() - t1
    tx = client.get_transaction(tx_id)
    keys = pm._function_keys("token.aleo", "transfer")
    assert tx.transitions()[0].proof is not None
    assert (keys.index.n, keys.index.m) == (8192, 32768)
    # the ledger verified the proof on broadcast; a copy with another public
    # input (and no serial numbers, which the first one spent) is refused
    bad = copy.deepcopy(tx)
    bad.id = "at1" + "0" * 32
    bt = bad.transitions()[0]
    bt.public_inputs[1] = (bt.public_inputs[1] + 1) % R
    bt.serial_numbers = []
    try:
        client.transaction_broadcast(bad)
        raise AssertionError("the ledger accepted a tampered proof")
    except ApiError as e:
        assert "invalid proof" in str(e), e
    # the wallet scan: one device ladder over the SDK_RECORDS ciphertexts
    lanes = []
    real = api_client.shared_secrets
    api_client.shared_secrets = lambda v, pts, device=None: lanes.append(len(pts)) or real(
        v, pts, device=device)
    try:
        found, scan_s = _timed(lambda: client.get_unspent_records(alice))
    finally:
        api_client.shared_secrets = real
    launches = all_launches()
    assert lanes == [SDK_RECORDS], lanes
    min_batch = api_client.BATCH_ECDH_MIN
    api_client.BATCH_ECDH_MIN = SDK_RECORDS + 1
    try:
        host_found, host_s = _timed(lambda: client.get_unspent_records(alice))
    finally:
        api_client.BATCH_ECDH_MIN = min_batch
    assert len(found) == SDK_RECORDS
    assert [(c, r.entries["microcredits"].data) for c, r in found] == \
        [(c, r.entries["microcredits"].data) for c, r in host_found], "the scans differ"
    for k in SDK_KERNELS:
        assert launches[k] > 0, f"{k} was never launched in the sdk phase"
    say({"phase": "sdk", "n": keys.index.n, "m": keys.index.m,
         "execute_prove_seconds": execute_s, "ledger_verified": True,
         "tampered_refused": True, "scan_ciphertexts": SDK_RECORDS,
         "scan_device_seconds": scan_s, "scan_host_seconds": host_s,
         "launches": _nonzero(launches), "seconds": round(time.time() - t0, 3)})
    return launches


def _proof_dims(tx):
    """[function, n, m] of each transition of a transaction, from its proof
    bytes (each must carry one)."""
    dims = []
    for t in tx.transitions():
        assert t.proof is not None, f"{t.function} carries no proof"
        _proof, n, m, _ell = proof_from_bytes(t.proof)
        dims.append([t.function, n, m])
    return dims


def _balances(ledger, *pks):
    client = LocalAPIClient(ledger, device=DEV)
    return [sorted(r.entries["microcredits"].data for _c, r in client.get_unspent_records(pk))
            for pk in pks]


def phase_serve():
    """The dev server, the proving worker and the CLI, each proving
    credits.aleo transitions on the card into a verifying ledger (see the
    module's docstring). The counts are set to 0 at the start and read at
    the end of the phase."""
    t0 = time.time()
    reset_launches()
    requests = []
    prof.enable()
    try:
        launches, summary = _serve_requests(requests)
    finally:
        prof.enable(False)
    for k in SDK_KERNELS:
        assert launches[k] > 0, f"{k} was never launched in the serve phase"
    torch.cuda.synchronize()
    say({"phase": "serve", "ledger_verified": True, **summary,
         "requests": [{k: v for k, v in r.items() if k != "tx"} for r in requests],
         "launches": _nonzero(launches), "seconds": round(time.time() - t0, 3)})
    return launches


def _serve_requests(requests):
    """Phase serve's three parts; each request's seconds, proofs and stage
    timers (key synthesis, proof, the ledger's verification) appended to
    `requests` -> (launches, summary)."""

    def request(name, ledger, fn):
        prof.reset()
        tx_id, seconds = _timed(fn)
        tx = ledger.transactions[tx_id]
        requests.append({"request": name, "tx": tx_id, "seconds": seconds,
                         "proofs": _proof_dims(tx),
                         "stages": {k: v["seconds"] for k, v in prof.report().items()
                                    if k.startswith(("pipeline/", "ledger/"))}})
        return tx

    ledger = Ledger(verify_proofs=True)
    alice, bob, carol = (PrivateKey(seed=SEED + 40 + i) for i in range(3))
    to_alice, to_bob = alice.address().to_string(), bob.address().to_string()
    ledger.genesis_mint(to_alice, SERVE_RECORDS * 1_000_000, n_records=SERVE_RECORDS)
    ledger.genesis_mint(carol.address().to_string(), 1_000_000)
    assert len(ledger.record_ciphertexts) < api_client.BATCH_ECDH_MIN
    # (a) the dev server, through the development client
    ct = encryptor.encrypt_private_key_with_secret(alice, "serve-pw")
    srv = DevServer(LocalAPIClient(ledger, device=DEV), key_ciphertext=ct,
                    host="127.0.0.1", port=0, prove=True, device=DEV)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        dc = DevelopmentClient(base)
        request("server transfer, request key", ledger,
                lambda: dc.transfer(100_000, 0, to_bob, private_key=alice.to_string()))
        request("server transfer, server key", ledger,
                lambda: dc.transfer(100_000, 0, to_bob, password="serve-pw"))
        tx = request("server join, fee", ledger, lambda: dc._post(
            "join", {"private_key": alice.to_string(), "fee": SERVE_FEE}))
        serials = [sn for t in tx.transitions() for sn in t.serial_numbers]
        assert len(serials) == 3 == len(set(serials)), serials
        assert tx.fee_transition is not None and tx.fee_transition.function == "fee"
        held = {r.serial_number(carol.sk): r.entries["microcredits"].data
                for _c, r in LocalAPIClient(ledger, device=DEV).get_unspent_records(carol)}
        tx = request("server split", ledger, lambda: dc._post(
            "split", {"private_key": carol.to_string(), "split_amount": SERVE_SPLIT}))
        (sn,) = tx.transitions()[0].serial_numbers
        assert SERVE_SPLIT < held[sn] < 2 * SERVE_SPLIT, held[sn]
        http = HttpAPIClient(base, device=DEV)
        assert http.latest_height() == ledger.latest_height
        for r in requests:
            assert wire.transaction_to_json(http.get_transaction(r["tx"])) == \
                wire.transaction_to_json(ledger.transactions[r["tx"]])
        # F6: every block read by its hash, equal to it read by its height
        t1 = time.time()
        for blk in ledger.blocks:
            assert wire.block_to_json(http.get_block_by_hash(blk.hash)) == \
                wire.block_to_json(http.get_block(blk.height)) == wire.block_to_json(blk), \
                f"block {blk.height} read by its hash differs"
        try:
            urllib.request.urlopen(f"{base}/testnet3/block/ab1{'0' * 64}", timeout=60)
            raise AssertionError("the server answered an unknown block hash")
        except urllib.error.HTTPError as e:
            assert e.code == 400, e.code
        blocks_by_hash, by_hash_s = len(ledger.blocks), time.time() - t1
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            assert json.loads(resp.read()) == "ok"
    finally:
        srv.stop()
    assert _balances(ledger, alice, bob, carol) == [
        [900_000, 900_000, 1_000_000 - SERVE_FEE, 1_000_000, 1_000_000, 1_000_000,
         2_000_000],
        [100_000, 100_000], [1_000_000 - SERVE_SPLIT, SERVE_SPLIT]]
    # (b) the proving worker, on the same ledger
    worker = ProvingWorker(LocalAPIClient(ledger, device=DEV), prove=True,
                           device=DEV).start()
    try:
        request("worker ALEO_TRANSFER private_to_public", ledger, lambda: worker.call({
            "type": "ALEO_TRANSFER", "amountCredits": 300_000, "recipient": to_alice,
            "transfer_type": "private_to_public", "privateKey": alice.to_string(),
        })["transaction"])
        request("worker ALEO_EXECUTE_PROGRAM_ON_CHAIN transfer_public", ledger,
                lambda: worker.call({
                    "type": "ALEO_EXECUTE_PROGRAM_ON_CHAIN", "programId": "credits.aleo",
                    "aleoFunction": "transfer_public", "inputs": [to_bob, "100000u64"],
                    "privateKey": alice.to_string(), "fee": 0,
                })["transaction"])
    finally:
        worker.stop()
    public = [ledger.get_mapping_value("credits.aleo", "account", pk.address().x).data
              for pk in (alice, bob)]
    assert public == [200_000, 100_000], public
    # (c) the CLI, its devnet file under a temporary directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_devnet_")
    devnet_path, saved = os.path.join(tmp, "devnet.pkl"), cli.DEVNET_PATH
    cli.DEVNET_PATH = devnet_path
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["devnet", "mint", "--address", to_alice, "--amount", "4000000",
                      "--records", "4"])

        def transfer():
            with contextlib.redirect_stdout(out):
                cli.main(["transfer", "--prove", "--device", "cuda", "--amount", "100000",
                          "--recipient", to_bob, "--private-key", alice.to_string()])
            return out.getvalue().split("transfer transaction: ")[1].split()[0]

        prof.reset()
        tx_id, seconds = _timed(transfer)
        stages = {k: v["seconds"] for k, v in prof.report().items() if k.startswith("pipeline/")}
        devnet = cli._load_ledger(DEV)
        tx = devnet.transactions[tx_id]
        requests.append({"request": "cli transfer --prove", "tx": tx_id, "seconds": seconds,
                         "proofs": _proof_dims(tx), "stages": stages})
        t = tx.transitions()[0]
        proof = proof_from_bytes(t.proof)[0]
        vk = devnet.function_vks["credits.aleo/transfer_private"]
        assert vk.srs.powers.x.device.type == "cuda"
        assert verify(vk, t.public_inputs, proof), "the CLI's proof does not verify"
        code = ("import torch\n"
                "assert not torch.cuda.is_available()\n"
                "from aleo_tpu_torch import cli\n"
                "cli.main(['devnet', 'status'])\n")
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "ALEO_TORCH_DEVNET_PATH": devnet_path})
        assert proc.returncode == 0 and "height: 2" in proc.stdout, proc.stdout + proc.stderr
    finally:
        cli.DEVNET_PATH = saved
        shutil.rmtree(tmp, ignore_errors=True)
    return all_launches(), {"join_serials_distinct": True, "split_record": held[sn],
                            "blocks_by_hash": blocks_by_hash, "blocks_by_hash_seconds": by_hash_s,
                            "devnet_status_without_cuda": proc.stdout.split("\n")[0]}


def phase_scan_widths():
    """The view-key ECDH of a record scan at SCAN_WIDTHS ciphertexts: the
    device ladder over all of them against the host ECDH of each, on the
    same points (running sums of two random points) and a random view
    scalar below the group order. Every lane is held equal. `crossover_est`
    is where a line through the device times (ladder seconds against width)
    meets the host's mean seconds a record times the width."""
    t0 = time.time()
    rng = random.Random(SEED + 13)
    view = rng.randrange(1, edwards.ORDER)
    P, Q = edwards.rand(rng), edwards.rand(rng)
    pts = [P]
    for _ in range(max(SCAN_WIDTHS) - 1):
        pts.append(edwards.add(pts[-1], Q))
    ed.shared_secrets(3, pts[:8])                       # first call on the card
    rows = []
    for w in SCAN_WIDTHS:
        got, dev_s = _timed(lambda: ed.shared_secrets(view, pts[:w]))
        want, host_s = _timed(lambda: [edwards.mul(view, p) for p in pts[:w]])
        assert got == want, f"shared_secrets differs from the host at {w} points"
        rows.append({"ciphertexts": w, "device_s": dev_s, "host_s": host_s,
                     "host_ms_per_record": 1e3 * host_s / w})
    widths, dev = [r["ciphertexts"] for r in rows], [r["device_s"] for r in rows]
    mw, md = sum(widths) / len(widths), sum(dev) / len(dev)
    slope = sum((w - mw) * (d - md) for w, d in zip(widths, dev)) / \
        sum((w - mw) ** 2 for w in widths)
    fixed = md - slope * mw
    host_per = sum(r["host_s"] for r in rows) / sum(widths)
    crossover = fixed / (host_per - slope) if host_per > slope else None
    say({"phase": "scan_widths", "view_bits": view.bit_length(), "widths": rows,
         "device_fixed_s": fixed, "device_s_per_record": slope,
         "host_s_per_record": host_per, "crossover_est": crossover,
         "batch_ecdh_min": api_client.BATCH_ECDH_MIN,
         "seconds": round(time.time() - t0, 3)})


def _ntt_check_limbs(logn, seed):
    """(2^logn, 16) uint16 limbs of the bench phase's NTT check input: random
    values below r, read as Montgomery forms (lane i holds limbs_i * 2^-256)."""
    a = np.random.default_rng(seed).integers(0, 1 << 16, size=(1 << logn, 16), dtype=np.uint16)
    a[:, 15] %= R >> 240
    return a


def _ntt_check_eval(logn, seed, x):
    """Host Horner evaluation of that input at x (run in a worker process)."""
    return rpoly.evaluate(limbs.limbs_to_ints(_ntt_check_limbs(logn, seed)), x) * FR_MONT_INV % R


def _fmat_reduce_at(M):
    """fmat_reduce against its plain version on the planted real columns of
    the first stage of an M-lane MatNTT, and its device time there."""
    _, _, prod = _stage_product(M, SEED + 40)
    t_cols = _stage_columns(prod, M)
    del prod
    got = fk.mont_reduce8(t_cols)
    err = int_err(got, fk._reduce_plain(t_cols))
    by_bytes = (fmat.K7 * 4 + fmat.L7) * M / HBM_BYTES_PER_S * 1e3
    by_ops = REDUCE_MADS * M / INT32_MADS_PER_S * 1e3
    res = {"lanes": M, "max_abs_err": err,
           "ms": kernel_ms(lambda a: fk.mont_reduce8(*a), copies((t_cols,), 2)),
           "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    assert err == 0, f"fmat_reduce disagrees with its plain version at {M} lanes"
    return res


def _rounds_of(fn):
    """(fn(), the bucket accumulation's rounds in it, seconds)."""
    r0 = msm_mod.ROUNDS["rounds"]
    out, secs = _timed(fn)
    return out, msm_mod.ROUNDS["rounds"] - r0, secs


def phase_bench(srs, keys):
    """The JAX package's bench entry point at its own sizes, through
    aleo_tpu_torch/bench.py's sections, each size held against the host
    first: the MSMs against the tiled oracle, the transforms on random data,
    K1 at the widest stage, then the timed sections and a batch of 16."""
    t0 = time.time()
    shift = params.FR_GENERATOR
    threshold = config.MATNTT_MIN_N
    assert config.MSM_AFFINE_MODE == "1" and threshold == 1 << 14
    modes = (("1", "affine"), ("0", "projective"))
    rounds, secs, ntt, on_card = {}, {}, {}, {}
    vectors_s = 0.0
    pool = ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    try:
        # the host's side, in worker processes while the card works: Horner
        # evaluations of the transforms' check inputs, and the tiled oracles
        rng = random.Random(SEED + 50)
        horner = {}
        for logn in BENCH_NTT_LOGNS:
            n = 1 << logn
            w = fr_root_of_unity(n)
            pts = [("ntt", rng.randrange(1, n)), ("ntt", rng.randrange(1, n)),
                   ("coset", rng.randrange(n))]
            horner[logn] = [(kind, k, pool.submit(
                _ntt_check_eval, logn, SEED + logn,
                pow(w, k, R) * (shift if kind == "coset" else 1) % R)) for kind, k in pts]
        oracle = lambda *arrays: pool.submit(bench.tiled_oracle, bench.class_sums(*arrays))
        want = {"msm": oracle(bench._rand_limbs(BENCH_MSM_N, 0xBE7C))}
        for i in range(BENCH_MSM_K):
            want[f"batch_{i}"] = oracle(bench._rand_limbs(BENCH_MSM_N, 100 + i))
        chunks = [bench._rand_limbs(BENCH_CHUNK, 7000 + i) for i in range(BENCH_CHUNKS)]
        for i, c in enumerate(chunks):
            want[f"chunk_{i}"] = oracle(c)
        want["sum"] = oracle(*chunks)
        del chunks

        # K1 at the widest stage of these transforms (a comparison: its
        # launches are not the path's, so the counts are reset after it)
        k1 = _fmat_reduce_at(BENCH_STAGE)
        reset_launches()

        # the MSMs at each size, both modes where asked, before any is timed
        got = {}
        table = msm_mod.make_table(bench._tiled_points(BENCH_MSM_N, DEV))
        sc = bench._rand_scalars(BENCH_MSM_N, 0xBE7C, DEV)
        sc_b = torch.stack([bench._rand_scalars(BENCH_MSM_N, 100 + i, DEV)
                            for i in range(BENCH_MSM_K)])
        try:
            for mode, name in modes:
                config.MSM_AFFINE_MODE = mode
                got[f"msm_2e16_{name}"], rounds[f"msm_2e16_{name}"], _ = _rounds_of(
                    lambda: msm_mod.msm_fast_host(sc, table))
            config.MSM_AFFINE_MODE = "1"
            got["batch"], rounds["batch_4x2e16"], _ = _rounds_of(
                lambda: msm_mod.msm_batch_host(sc_b, table))
            got["singles"] = [msm_mod.msm_fast_host(sc_b[i], table) for i in range(BENCH_MSM_K)]
            del table, sc, sc_b
            table = msm_mod.make_table(bench._tiled_points(BENCH_CHUNK, DEV))
            sc = bench._rand_scalars(BENCH_CHUNK, 7000, DEV)
            for mode, name in modes:
                config.MSM_AFFINE_MODE = mode
                got[f"chunk_2e22_{name}"], rounds[f"chunk_2e22_{name}"], \
                    secs[f"chunk_2e22_{name}"] = _rounds_of(lambda: msm_mod.msm_fast_host(sc, table))
        finally:
            config.MSM_AFFINE_MODE = "1"
        del table, sc
        for key in ("msm_2e16_affine", "msm_2e16_projective"):
            assert got[key] == want["msm"].result(), f"{key} disagrees with the tiled oracle"
            held("msm", point_to_bytes(got[key]).hex() == JAX["msm"]["point"], key)
        batch_want = [want[f"batch_{i}"].result() for i in range(BENCH_MSM_K)]
        assert got["batch"] == got["singles"] == batch_want, \
            "msm_batch_host at k = 4 x 2^16 disagrees with msm_fast_host or the oracle"
        for key in ("chunk_2e22_affine", "chunk_2e22_projective"):
            assert got[key] == want["chunk_0"].result(), f"{key} disagrees with the tiled oracle"
        assert rounds["chunk_2e22_affine"] >= BENCH_CHUNK >> 11, rounds

        # the MSM sections, timed, and their points against the oracle
        detail = {}
        (pps, out, outs), rounds["bench_msm"], secs["bench_msm"] = _rounds_of(
            lambda: bench.bench_msm(detail, DEV))
        assert out == want["msm"].result() and outs == batch_want, "bench_msm's points"
        held("msm", point_to_bytes(out).hex() == JAX["msm"]["point"], "bench_msm's point")
        (total, parts), rounds["bench_msm_2e24"], secs["bench_msm_2e24"] = _rounds_of(
            lambda: bench.bench_msm_2e24(detail, DEV))
        for i, part in enumerate(parts):
            assert part == want[f"chunk_{i}"].result(), f"chunk {i} of the 2^24 MSM"
        assert total == want["sum"].result(), "the 2^24 MSM disagrees with the tiled oracle"

        # the transforms at 2^20 and 2^22 on random data: MatNTT against the
        # butterfly, the round trips, index 0 against the host sum, and
        # Horner evaluations at w^k and g w^k
        for logn in BENCH_NTT_LOGNS:
            n = 1 << logn
            a = _ntt_check_limbs(logn, SEED + logn)
            x = torch.from_numpy(a.T.astype(np.int32)).contiguous().to(DEV)
            host_sum = sum(int(v) << (16 * k) for k, v in
                           enumerate(a.sum(axis=0, dtype=np.int64))) * FR_MONT_INV % R
            jax_ntt = JAX["ntt"][str(n)]
            held("ntt", sha256(a.tobytes()) == jax_ntt["inputs"]["input_sha256"],
                 f"the transforms' input at 2^{logn}")
            del a
            before = fk.LAUNCHES["fmat_reduce"]
            ev, ev_s = _timed(lambda: dntt.ntt_lf(x))
            cev, cev_s = _timed(lambda: dntt.coset_ntt_lf(x, shift))
            assert fk.LAUNCHES["fmat_reduce"] > before, f"2^{logn} did not run MatNTT"
            # every output value against the JAX package's ntt / coset_ntt
            t1 = time.time()
            for name, v in (("ntt", ev), ("coset_ntt", cev)):
                jw = jax_ntt[name]
                idx = [i for i, _ in jw["samples"]]
                samples = [str(y) for y in lf.decode(v[:, idx])] == [y for _, y in jw["samples"]]
                digest = fr_digest(v) == jw["sha256"]
                held("ntt", samples and digest,
                     f"MatNTT {name} at 2^{logn} (samples equal: {samples}, digest equal: {digest})")
            vectors_s += time.time() - t1
            assert torch.equal(lf.normalize(dntt.intt_lf(ev)), x), f"round trip at 2^{logn}"
            assert torch.equal(lf.normalize(dntt.coset_intt_lf(cev, shift)), x), \
                f"coset round trip at 2^{logn}"
            before = fk.LAUNCHES["fmat_reduce"]
            config.MATNTT_MIN_N = 1 << 40                   # the butterfly network
            try:
                bev, bfly_s = _timed(lambda: dntt.ntt_lf(x))
                bcev, cbfly_s = _timed(lambda: dntt.coset_ntt_lf(x, shift))
            finally:
                config.MATNTT_MIN_N = threshold
            assert fk.LAUNCHES["fmat_reduce"] == before
            assert torch.equal(lf.normalize(ev), lf.normalize(bev)), \
                f"MatNTT disagrees with the butterfly at 2^{logn}"
            assert torch.equal(lf.normalize(cev), lf.normalize(bcev)), \
                f"coset MatNTT disagrees with the butterfly at 2^{logn}"
            del bev, bcev
            assert lf.decode(ev[:, :1]) == [host_sum], f"index 0 at 2^{logn}"
            on_card[logn] = [lf.decode((ev if kind == "ntt" else cev)[:, [k]])[0]
                             for kind, k, _ in horner[logn]]
            ntt[str(n)] = {"matntt_s": ev_s, "coset_matntt_s": cev_s, "butterfly_s": bfly_s,
                           "coset_butterfly_s": cbfly_s,
                           "indices": [[kind, k] for kind, k, _ in horner[logn]]}
            del x, ev, cev

        # the NTT section, timed
        sums, secs["bench_ntt"] = _timed(lambda: bench.bench_ntt(detail, DEV))

        # a batch of 16 transfers (the bench's inputs), proofs 0 and 15 verified
        reg = load_example("simple_token")
        if keys is None:
            keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
        syns = [pipeline.synthesize_and_check(
            keys, reg, bench._transfer_inputs(100 + i, SENDER, RECEIVER), SENDER, lambda: 11)
            for i in range(BENCH_PROOFS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        proofs, secs["batch16"] = _timed(lambda: batch_mod.prove_batch(
            keys.index, [s.cs for s in syns], rng=random.Random(SEED)))
        peak16 = torch.cuda.max_memory_allocated()
        assert len(proofs) == BENCH_PROOFS
        t1 = time.time()
        for i in (0, BENCH_PROOFS - 1):
            assert verify(keys.vk, syns[i].public_inputs, proofs[i]), \
                f"proof {i} of the batch of {BENCH_PROOFS} does not verify"
        assert not verify(keys.vk, syns[1].public_inputs, proofs[0]), \
            "proof 0 was accepted under proof 1's public inputs"
        verify16_s = time.time() - t1

        for logn in BENCH_NTT_LOGNS:
            for (kind, k, fut), got_k in zip(horner[logn], on_card[logn]):
                assert got_k == fut.result(), f"{kind} at 2^{logn}, index {k}: not Horner's"
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    launches = all_launches()
    for kname in AFFINE_KERNELS + PROJECTIVE_KERNELS + ("g1_normalize", "fmat_reduce"):
        assert launches[kname] > 0, f"{kname} was never launched in the bench phase"
    say({"phase": "bench", "fmat_reduce_2p22": k1, "rounds": rounds, "seconds_of": secs,
         "jax_vectors": {"ntt": True, "msm": True}, "jax_vectors_seconds": vectors_s,
         "ntt_checks": ntt, "ntt_checksums": sums, "msm_2e16_points_per_s": pps,
         "batch16": {"seconds": secs["batch16"], "seconds_per_proof": secs["batch16"] / BENCH_PROOFS,
                     "peak_device_bytes": peak16, "verify_seconds": verify16_s,
                     "proofs_verified": 2},
         "detail": detail, "launches": _nonzero(launches),
         "seconds": round(time.time() - t0, 3)})
    return launches


def _load_tool(name):
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name, os.path.join(here, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_tools():
    """The path that runs the three product kernels: the two stand-alone
    scripts, in this process, at their default sizes."""
    t0 = time.time()
    reset_launches()
    assert _load_tool("torch_proto_mul").main([]) == 0
    assert _load_tool("torch_microbench_fr_mul").main([]) == 0
    torch.cuda.synchronize()
    launches = all_launches()
    for kname in PROTO_KERNELS:
        assert launches[kname] > 0, f"{kname} was never launched by its script"
    say({"phase": "tools", "launches": {k: launches[k] for k in PROTO_KERNELS},
         "seconds": round(time.time() - t0, 3)})
    return launches


def main(argv):
    t_all = time.time()
    want = set(argv) or set(PHASES)
    if want - PHASES - OPT_IN_PHASES:
        sys.exit(f"chip_smoke: unknown phase {sorted(want - PHASES - OPT_IN_PHASES)}")
    JAX.update(load_vectors())
    card = phase_device()
    kres = phase_kernels() if "kernels" in want else None
    srs = None
    if want & {"msm", "micro", "transfer", "credits", "batch", "fixed_base", "limbs_last",
               "mesh", "sdk", "serve", "bench"}:
        t0 = time.time()
        # one SRS for all: max(2n + 1, m) + 1 powers for n = 8192, m = 32768
        # (micro needs fewer and takes the same one); cached where the
        # pipeline's own key synthesis (phases sdk and serve) looks for it
        full = bool(want - {"micro", "kernels", "matntt", "tools", "record_scan"})
        deg = SRS_DEGREE if full else 8193
        srs = Srs.load_or_generate(deg, seed=SRS_SEED, device=DEV)
        held_srs = {}
        if full:
            # the G1 powers against the JAX package's SRS, by digest
            t1 = time.time()
            digest = hashlib.sha256()
            for p in srs.host_affine():
                digest.update(point_to_bytes(p))
            held("srs", digest.hexdigest() == JAX["srs"]["g1_powers_sha256"], "the SRS")
            held_srs = {"jax_vectors": {"srs": True}, "jax_vectors_seconds": time.time() - t1}
        say({"phase": "srs", "powers": deg + 1, **held_srs, "seconds": round(time.time() - t0, 3)})
    to_affine_launches = None
    if "msm" in want:
        to_affine_launches = phase_msm(srs)
    if "matntt" in want:
        phase_matntt()
    if "micro" in want:
        phase_micro(srs)
    launches, keys, single_s = None, None, None
    if "transfer" in want:
        launches, keys, single_s = phase_transfer(srs)
    credits_launches = phase_credits(srs) if "credits" in want else None
    batch_launches = phase_batch(srs, keys, single_s) if "batch" in want else None
    fb_launches = phase_fixed_base(srs, keys) if "fixed_base" in want else None
    bench_launches = phase_bench(srs, keys) if "bench" in want else None
    tool_launches = phase_tools() if "tools" in want else None
    ll_launches = phase_limbs_last(srs) if "limbs_last" in want else None
    if "record_scan" in want:
        phase_record_scan()
    mesh_launches = phase_mesh(srs, keys) if "mesh" in want else None
    sdk_launches = phase_sdk() if "sdk" in want else None
    serve_launches = phase_serve() if "serve" in want else None
    if "scan_widths" in want:
        phase_scan_widths()
    if None not in (kres, launches, credits_launches, batch_launches, tool_launches,
                    to_affine_launches, fb_launches, ll_launches, mesh_launches, sdk_launches,
                    serve_launches, bench_launches):
        # `launches` is a kernel's count on the main path that runs it: the
        # transfer proof (K1-K12 and the inversion tree), to_affine (fq_mul),
        # the two scripts (the product kernels); `launches_credits` its count
        # in the credits phase (three functions' keys, proofs and
        # verifications, and join's projective proof); `launches_batch` in
        # the k = 4 batch; `launches_fixed_base` in the transfer proof
        # with the fixed-base MSM on ("auto") that builds its tables;
        # `launches_limbs_last` in the limbs_last phase; `launches_mesh` in
        # the mesh phase's sharded calls; `launches_sdk` in the sdk phase;
        # `launches_serve` in the serve phase; `launches_bench` in the bench
        # phase (after its check of fmat_reduce against the plain version)
        on_path = {**launches, "fq_mul": to_affine_launches["fq_mul"],
                   **{k: tool_launches[k] for k in PROTO_KERNELS}}
        say({"kernels": [
            {"name": name, "route": "cuda",
             "source": KERNELS[name][0], "replaces": KERNELS[name][1],
             "launches": on_path[name], "launches_credits": credits_launches[name],
             "launches_batch": batch_launches[name],
             "launches_fixed_base": fb_launches[name],
             "launches_limbs_last": ll_launches.get(name, 0),
             "launches_mesh": mesh_launches.get(name, 0),
             "launches_sdk": sdk_launches.get(name, 0),
             "launches_serve": serve_launches.get(name, 0),
             "launches_bench": bench_launches.get(name, 0),
             "max_abs_err": r["max_abs_err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None}
            for name, r in kres.items()
        ]})
    torch.cuda.synchronize()
    print(card, flush=True)
    say({"total_seconds": round(time.time() - t_all, 3)})
    if want != PHASES:
        print("partial run: no result line", flush=True)
        return 0
    say({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
