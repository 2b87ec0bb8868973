"""CRC-16-CCITT as a GF(2) affine map -> batched device matmul.

The bitwise CRC update (protocol.py:331-347: poly 0x1021, init 0xFFFF, MSB
first, no reflection) is linear over GF(2) in the message bits, so for a fixed
message length M:

    crc(bits) = (A @ bits) mod 2  XOR  crc(zeros_M)

with A a 16xM binary matrix whose column i is crc(e_i) ^ crc(0).  A batch of
frames then computes all CRCs in one (F, M) x (M, 16) int matmul instead
of a per-bit Python loop.

`crc16_bits` is the exact scalar oracle (host).  `soft_crc_check_*` implement
the reference's soft acceptance: <=2 bit errors, with a reversed-payload
retry (protocol.py:292-329).
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np
import jax.numpy as jnp

from tetraear_tpu import constants as C


def crc16_bits(bits) -> int:
    """Exact reference CRC: one shift per message bit (protocol.py:331-343)."""
    crc = C.CRC16_INIT
    for bit in np.asarray(bits).astype(np.int64) & 1:
        crc ^= int(bit) << 15
        if crc & 0x8000:
            crc = ((crc << 1) ^ C.CRC16_POLY) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return crc


def crc16_bits_arr(bits) -> np.ndarray:
    """CRC as a 16-element MSB-first bit array (protocol.py:346-347)."""
    crc = crc16_bits(bits)
    return np.array([(crc >> i) & 1 for i in range(15, -1, -1)], dtype=np.uint8)


@functools.lru_cache(maxsize=32)
def _crc_matrix(m: int) -> tuple[np.ndarray, np.ndarray]:
    """(A, c0): crc_bits(x) = (A @ x) % 2 ^ c0 for messages of length m.

    Built incrementally: track, for each of the 16 CRC state bits, its GF(2)
    dependence on each message bit, by stepping the linear recurrence once
    per message position.  O(m) setup, cached per length.
    """
    # state_dep[s] = length-m uint8 vector: dependence of state bit s on input
    # state_const = 16 bits: affine part (from init 0xFFFF)
    state_dep = np.zeros((16, m), dtype=np.uint8)
    state_const = np.array([(C.CRC16_INIT >> (15 - s)) & 1 for s in range(16)],
                           dtype=np.uint8)
    poly_bits = np.array([(C.CRC16_POLY >> (15 - s)) & 1 for s in range(16)],
                         dtype=np.uint8)
    for i in range(m):
        # feedback bit = state_bit0 XOR input_i
        fb_dep = state_dep[0].copy()
        fb_dep[i] ^= 1
        fb_const = state_const[0]
        # shift left, inject feedback times polynomial
        new_dep = np.zeros_like(state_dep)
        new_dep[:15] = state_dep[1:]
        new_const = np.zeros_like(state_const)
        new_const[:15] = state_const[1:]
        new_dep ^= poly_bits[:, None] * fb_dep[None, :]
        new_const ^= poly_bits * fb_const
        state_dep, state_const = new_dep, new_const
    return state_dep, state_const


def crc16_batch(bits: jnp.ndarray) -> jnp.ndarray:
    """Batched CRC over the last axis.

    bits: (..., M) in {0,1} -> (..., 16) uint8 CRC bits (MSB first).
    """
    m = bits.shape[-1]
    A, c0 = _crc_matrix(m)
    x = bits.astype(jnp.int32)
    acc = jnp.einsum("...m,sm->...s", x, jnp.asarray(A, jnp.int32),
                     preferred_element_type=jnp.int32)
    return ((acc & 1) ^ jnp.asarray(c0, jnp.int32)).astype(jnp.uint8)


def soft_crc_check_batch(data_bits: jnp.ndarray) -> jnp.ndarray:
    """Vectorized reference _check_crc (protocol.py:292-329) over frames.

    data_bits: (..., D) with D >= 16; payload = [:-16], received = [-16:].
    Pass conditions: not all-ones/all-zeros, and (errors <= 2 on the forward
    payload CRC) or (errors <= 2 on the reversed-payload CRC).
    Returns (...,) bool.
    """
    d = data_bits.shape[-1]
    if d < 16:
        return jnp.zeros(data_bits.shape[:-1], bool)
    payload = data_bits[..., :-16]
    received = data_bits[..., -16:].astype(jnp.int32)

    ones = data_bits.sum(axis=-1)
    nondegenerate = (ones != 0) & (ones != d)

    fwd = crc16_batch(payload).astype(jnp.int32)
    rev = crc16_batch(payload[..., ::-1]).astype(jnp.int32)
    err_f = jnp.sum(fwd != received, axis=-1)
    err_r = jnp.sum(rev != received, axis=-1)
    ok = (err_f <= C.CRC_SOFT_ERROR_BUDGET) | (err_r <= C.CRC_SOFT_ERROR_BUDGET)
    return nondegenerate & ok


@functools.lru_cache(maxsize=4)
def _dense_crc_kernel() -> tuple:
    """(kernel, c0) for the sliding soft-CRC conv.

    A frame window (510 bits) carries its data region at window offsets
    {0..107} u {122..229} (the sync-overlap geometry, constants
    BURST_BLOCK1/2): payload = 200 bits, received CRC = 16 bits at
    offsets 214..229.  CRC-16 is GF(2)-linear, so the CRC of EVERY
    window position is one cross-correlation of the bit stream with a
    (33, 230) kernel: rows 0-15 = forward-payload CRC dependence, rows
    16-31 = reversed-payload, row 32 = ones over the data offsets (the
    all-0/all-1 degeneracy counter)."""
    A, c0 = _crc_matrix(200)
    # payload bit j lives at window offset j (j<108) else j+14
    off = np.concatenate([np.arange(108), np.arange(108, 200) + 14])
    kernel = np.zeros((33, 1, 230), np.float32)
    kernel[np.arange(16)[:, None], 0, off[None, :]] = A
    kernel[16 + np.arange(16)[:, None], 0, off[None, ::-1]] = A
    # fold the RECEIVED CRC bit (window offset 214+s, disjoint from the
    # payload offsets) into row s: parity(computed + received) is the
    # XOR, so the error count needs no separately-materialized stack of
    # 16 shifted bit slices — at PFB bench scale that stack was a
    # (96, 16, P) int32 (~0.8 GB) intermediate
    kernel[np.arange(16), 0, 214 + np.arange(16)] = 1.0
    kernel[16 + np.arange(16), 0, 214 + np.arange(16)] = 1.0
    data_off = np.concatenate([np.arange(108), np.arange(108, 216) + 14])
    kernel[32, 0, data_off] = 1.0
    return kernel, c0


@functools.lru_cache(maxsize=4)
def _dense_crc_kernel_of(fold: int) -> tuple:
    """Output-folded dense-CRC kernel: (33*fold, 1, 229+fold), c0.

    Same trick as ops/fused.s2d_of_kernel: the 33-output-channel CRC
    conv has only 33 output channels; folding `fold`
    consecutive window positions into the channel dimension gives
    33*fold output rows (132 at fold=4) at the cost of fold-1 zero taps
    per row, with a stride-`fold` conv.  out[o, w*fold + r] =
    (stride-fold conv)[o*fold + r, w] — identical sums, laid out
    differently."""
    kernel, c0 = _dense_crc_kernel()
    k = np.asarray(kernel)                      # (33, 1, 230)
    k3 = np.zeros((33, fold, 1, 230 + fold - 1), np.float32)
    for r in range(fold):
        k3[:, r, :, r:r + 230] = k
    return k3.reshape(33 * fold, 1, 230 + fold - 1), c0


def _crc_dense_defaults() -> tuple:
    """(fold, bf16) for soft_crc_dense when the caller does not choose.

    TETRAEAR_CRC_DENSE: "legacy" (fold=1 f32 — the r2-r4 verified
    program) or "of<F>[_bf16]".  The folded variant is bit-identical
    by construction; it becomes the default only after a measured
    device win."""
    v = os.environ.get("TETRAEAR_CRC_DENSE", "legacy")
    if v == "legacy":
        return 1, False
    m = re.fullmatch(r"of(\d+)(_bf16)?", v)
    if not m:
        raise ValueError(f"TETRAEAR_CRC_DENSE={v!r} invalid")
    return int(m.group(1)), bool(m.group(2))


def soft_crc_dense(bits: jnp.ndarray, fold: int | None = None,
                   bf16: bool | None = None) -> jnp.ndarray:
    """Reference soft-CRC verdict at EVERY frame-window start position.

    bits: (..., B) in {0,1} -> (..., B-229) bool where out[..., s] is
    the _check_crc verdict of the window starting at bit s.  One dense
    33-channel convolution instead of per-candidate window gathers
    — and it scores every position, not just a top-K subset.  Equivalence with
    soft_crc_check_batch on extracted windows is pinned by tests.

    fold > 1 output-folds the conv into 33*fold output channels; bf16
    casts the
    inputs (bits and a 0/1 kernel are exact in bf16, accumulation stays
    f32, so every sum — integers <= 233 — is EXACT and the verdict is
    bit-identical; pinned by tests/unit/test_ops_demod.py).
    """
    from jax import lax
    if fold is None or bf16 is None:
        dfold, dbf16 = _crc_dense_defaults()
        fold = dfold if fold is None else fold
        bf16 = dbf16 if bf16 is None else bf16
    b = bits.shape[-1]
    if b < 230:
        return jnp.zeros(bits.shape[:-1] + (0,), bool)
    p = b - 229
    dt = jnp.bfloat16 if bf16 else jnp.float32
    if fold > 1:
        kernel_np, c0 = _dense_crc_kernel_of(fold)
        wf = -(-p // fold)                       # ceil: stride-F count
        # pad so every stride-F window exists; positions >= p sliced off
        need = (wf - 1) * fold + (230 + fold - 1)
        x = bits.astype(dt).reshape((-1, 1, b))
        if need > b:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, need - b)))
        out = lax.conv_general_dilated(
            x, jnp.asarray(kernel_np, dt), (fold,), ((0, 0),),
            dimension_numbers=("NCW", "OIW", "NCW"),
            preferred_element_type=jnp.float32)  # (N, 33F, wf)
        n_rows = out.shape[0]
        out = out.reshape(n_rows, 33, fold, wf).transpose(0, 1, 3, 2)
        out = out.reshape(n_rows, 33, wf * fold)[..., :p]
    else:
        kernel_np, c0 = _dense_crc_kernel()
        x = bits.astype(dt).reshape((-1, 1, b))
        out = lax.conv_general_dilated(
            x, jnp.asarray(kernel_np, dt), (1,), ((0, 0),),
            dimension_numbers=("NCW", "OIW", "NCW"),
            preferred_element_type=jnp.float32)   # (N, 33, B-229)
    sums = out.astype(jnp.int32)
    # rows 0..31 already include the received CRC bit via the kernel tap
    # (see _dense_crc_kernel) — parity(computed + received + c0) is the
    # per-bit XOR, no shifted-slice stack needed
    c0_j = jnp.asarray(c0.astype(np.int32))[None, :, None]
    err_f = jnp.sum((sums[:, :16] + c0_j) & 1, axis=1)
    err_r = jnp.sum((sums[:, 16:32] + c0_j) & 1, axis=1)
    ones = sums[:, 32]
    nondegen = (ones != 0) & (ones != 216)
    ok = ((err_f <= C.CRC_SOFT_ERROR_BUDGET)
          | (err_r <= C.CRC_SOFT_ERROR_BUDGET)) & nondegen
    return ok.reshape(bits.shape[:-1] + (p,))


def soft_crc_check_host(data_bits) -> bool:
    """Exact host-side reference _check_crc for a single frame.

    Uses the native engine (native/hostdsp.cpp) when built — identical
    verdicts, without the per-bit Python loop (the hot host gate in
    decode_frame); falls back to the pure-Python oracle."""
    from tetraear_tpu.utils import native_dsp
    nv = native_dsp.soft_crc_check(data_bits, C.CRC_SOFT_ERROR_BUDGET)
    if nv is not None:
        return nv
    return _py_soft_crc_check_host(data_bits)


def _py_soft_crc_check_host(data_bits) -> bool:
    """Pure-Python oracle for soft_crc_check_host (parity-tested against
    the native engine in tests/unit/test_native_dsp.py)."""
    bits = np.asarray(data_bits).astype(np.uint8) & 1
    if bits.size < 16:
        return False
    ones = int(bits.sum())
    if ones == 0 or ones == bits.size:
        return False
    payload, received = bits[:-16], bits[-16:]
    if int(np.sum(crc16_bits_arr(payload) != received)) <= C.CRC_SOFT_ERROR_BUDGET:
        return True
    if int(np.sum(crc16_bits_arr(payload[::-1]) != received)) <= C.CRC_SOFT_ERROR_BUDGET:
        return True
    return False
