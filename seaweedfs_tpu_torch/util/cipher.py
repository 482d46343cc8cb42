"""AES-256-GCM content cipher (weed/util/cipher.go analog).

Chunks uploaded with ?cipher=true are encrypted with a random per-chunk
key; the key travels in the chunk metadata (filer entry), never with the
stored bytes — same trust model as the reference.

The port's copy of ``seaweedfs_tpu/util/cipher.py``. It imports
``cryptography``, so nothing on a server's or the CLI's start-up path
imports it.
"""

from __future__ import annotations

import os

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

NONCE_SIZE = 12


def gen_cipher_key() -> bytes:
    return os.urandom(32)


def encrypt(data: bytes, key: bytes) -> bytes:
    """nonce || ciphertext+tag (cipher.go Encrypt)."""
    nonce = os.urandom(NONCE_SIZE)
    return nonce + AESGCM(key).encrypt(nonce, data, None)


def decrypt(blob: bytes, key: bytes) -> bytes:
    nonce, ct = blob[:NONCE_SIZE], blob[NONCE_SIZE:]
    return AESGCM(key).decrypt(nonce, ct, None)
