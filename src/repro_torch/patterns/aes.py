"""AES-256 (ECB over blocks) — Partitioned Data pattern (port of
``repro/patterns/aes.py``).

Plaintext is chunked across devices, every device encrypts its chunk,
zero cross-device traffic.  Full AES-256 on uint8 tensors: SubBytes by
an S-box gather, ShiftRows by a fixed gather, MixColumns in GF(2^8) with
uint8 bit operations.  The tables and the key expansion are numpy, on
the host, as in the reference (copied, not imported).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .mesh import DEV, shard_map
from .unified import local, unified

PATTERN = "partitioned"


# --------------------------------------------------------------------------
# tables (generated, not typed in)
# --------------------------------------------------------------------------

def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


@functools.lru_cache(None)
def _sbox() -> np.ndarray:
    # multiplicative inverse in GF(2^8) + affine transform (FIPS-197 5.1.1)
    inv = np.zeros(256, np.uint8)
    for a in range(1, 256):
        for b in range(1, 256):
            if _gf_mul(a, b) == 1:
                inv[a] = b
                break
    out = np.zeros(256, np.uint8)
    for i in range(256):
        x = int(inv[i])
        y = x
        for _ in range(4):
            x = ((x << 1) | (x >> 7)) & 0xFF
            y ^= x
        out[i] = y ^ 0x63
    return out


def sbox() -> np.ndarray:
    """The AES S-box (256,) uint8 (a fresh copy)."""
    return _sbox().copy()


_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80,
                  0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D], np.uint8)


def expand_key(key: np.ndarray) -> np.ndarray:
    """key (32,) uint8 -> round keys (15, 16) uint8 (AES-256, Nk=8)."""
    S = _sbox()
    w = [key[4 * i:4 * i + 4].copy() for i in range(8)]
    for i in range(8, 60):
        t = w[i - 1].copy()
        if i % 8 == 0:
            t = np.roll(t, -1)
            t = S[t]
            t[0] ^= _RCON[i // 8 - 1]
        elif i % 8 == 4:
            t = S[t]
        w.append(w[i - 8] ^ t)
    return np.concatenate(w).reshape(15, 16)


# --------------------------------------------------------------------------
# the cipher (vectorised over blocks)
# --------------------------------------------------------------------------

# ShiftRows on column-major state bytes b[r + 4c]: the gather indices
_SHIFT_IDX = np.array([(i + 4 * (i % 4)) % 16 for i in range(16)])


def _xtime(a):
    # xor 0x1B where the top bit falls off; no constant tensors, so every
    # op of the program descends from its operands
    return (a << 1) ^ ((a >> 7) * 0x1B)


def encrypt_blocks(blocks, round_keys, sbox_table):
    """blocks (N,16) uint8, round_keys (15,16), sbox (256,) -> (N,16)."""
    shift = torch.as_tensor(_SHIFT_IDX, device=blocks.device)
    st = blocks ^ round_keys[0]
    # SubBytes and ShiftRows act on each block alone, with the table and
    # the row shifts whole
    sub_shift = local(lambda st, table, shift: table[st.long()][:, shift],
                      (DEV, None, None), DEV)

    def mix(st):
        s = st.reshape(-1, 4, 4)                    # columns (N, col, row)
        a0, a1, a2, a3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
        x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
        b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
        b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
        b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
        b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
        return torch.stack([b0, b1, b2, b3], dim=2).reshape(-1, 16)

    for rnd in range(1, 14):
        st = mix(sub_shift(st, sbox_table, shift)) ^ round_keys[rnd]
    return sub_shift(st, sbox_table, shift) ^ round_keys[14]


# --------------------------------------------------------------------------
# oracle + modes
# --------------------------------------------------------------------------

def reference(plain: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle (independent of the torch path)."""
    S = _sbox()
    rk = expand_key(key)
    st = plain.reshape(-1, 16) ^ rk[0]

    def mix_np(st):
        s = st.reshape(-1, 4, 4).astype(np.uint8)
        out = np.empty_like(s)
        for c in range(4):
            a = s[:, c, :]
            x = ((a << 1) ^ np.where(a & 0x80, 0x1B, 0)).astype(np.uint8)
            out[:, c, 0] = x[:, 0] ^ (x[:, 1] ^ a[:, 1]) ^ a[:, 2] ^ a[:, 3]
            out[:, c, 1] = a[:, 0] ^ x[:, 1] ^ (x[:, 2] ^ a[:, 2]) ^ a[:, 3]
            out[:, c, 2] = a[:, 0] ^ a[:, 1] ^ x[:, 2] ^ (x[:, 3] ^ a[:, 3])
            out[:, c, 3] = (x[:, 0] ^ a[:, 0]) ^ a[:, 1] ^ a[:, 2] ^ x[:, 3]
        return out.reshape(-1, 16)

    for rnd in range(1, 14):
        st = mix_np(S[st][:, _SHIFT_IDX]) ^ rk[rnd]
    return (S[st][:, _SHIFT_IDX] ^ rk[14]).reshape(plain.shape)


def default_size(n_devices: int) -> int:
    return 256 * 1024 * max(1, n_devices // 1)      # Table 2: 256KB x devs


def make_umode(mesh):
    return unified(encrypt_blocks, mesh, in_specs=(DEV, None, None),
                   out_specs=DEV)


def make_dmode(mesh):
    def local(blocks, rks, sbs):                     # no collectives at all
        return [encrypt_blocks(b, rk, sb)
                for b, rk, sb in zip(blocks, rks, sbs)]
    return shard_map(local, mesh, in_specs=(DEV, None, None), out_specs=DEV)


def make_args(size_bytes: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    plain = rng.integers(0, 256, (size_bytes // 16, 16), dtype=np.uint8)
    key = rng.integers(0, 256, 32, dtype=np.uint8)
    return plain, key, expand_key(key), sbox()
