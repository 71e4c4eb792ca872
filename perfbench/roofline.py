"""The least time the card could take for the hashing the window asked
for, from the shapes alone: the larger of the bytes the inputs need
(read once, outputs written once) at the HBM rate and the fewest integer
instructions Hopper can issue for them.

``ops_per_compression`` and ``sliding_ops`` are frozen copies of
``chip_smoke.py``'s counts, so any implementation of a kernel is held to
the same work.
"""
from __future__ import annotations

from typing import Iterable, Tuple

# H100 SXM, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer instructions an SM issues per clock on compute
# capability 9.0: 64 on the ALU pipe and 64 (IMAD) on the FMA pipe
INT_OPS_PER_SM_CLOCK = 128
# rounds of a compression whose result reaches digest word a (a is a0
# plus the b that round 60, 0-based, writes)
LIVE_ROUNDS = 61


def ops_per_compression(const_words: int = 0, final_adds: int = 4) -> int:
    """Integer instructions per 64-byte MD5 compression, the least Hopper
    can issue: per round one LOP3, two adds for f + a + K + M (one when
    message word M is a compile-time constant, since K + M folds), one
    funnel shift and one add; then the final adds."""
    return 64 * 5 - 4 * const_words + final_adds


def message_word(i: int) -> int:
    return i if i < 16 else (5 * i + 1) % 16 if i < 32 \
        else (3 * i + 5) % 16 if i < 48 else (7 * i) % 16


def sliding_ops(w_words: int) -> int:
    """Integer instructions per sliding window of ``w_words`` words for
    digest word a alone: each of the LIVE_ROUNDS rounds is one LOP3, two
    adds for f + a + K + M (one where M is a constant: padding, zeros or
    the length) and one LEA.HI for b + rotl(f, s); round 0's boolean
    function and a + K are constants of the initial value, and so is
    a + K in rounds 1-3; one final add."""
    total = 0
    for i in range(LIVE_ROUNDS):
        const_m = message_word(i) >= w_words
        total += 4 - const_m
        if i == 0:
            total -= 2
        elif i < 4 and not const_m:
            total -= 1
    return total + 1


def md5_message_bytes(chunk_len: int) -> int:
    """Bytes of a block's digest message: the block padded to 4 bytes,
    then its 4-byte length."""
    return (chunk_len + 3) // 4 * 4 + 4


def md5_direct_work(chunk_lens: Iterable[int]) -> Tuple[float, float]:
    """(integer instructions, bytes) of the direct MD5 of these blocks."""
    ops = nbytes = 0
    for n in chunk_lens:
        m = md5_message_bytes(n)
        ops += ops_per_compression() * ((m + 9 + 63) // 64)
        nbytes += m + 16
    return float(ops), float(nbytes)


def sliding_work(length: int, window: int, stride: int) -> Tuple[float, float]:
    """(integer instructions, bytes) of the window hashes of one buffer."""
    n = max((length - window) // stride + 1, 0)
    return float(sliding_ops(window // 4) * n), float(length + 4 * n)


def least_seconds(ops: float, nbytes: float, sms: int,
                  sm_clock_hz: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               ops / (INT_OPS_PER_SM_CLOCK * sms * sm_clock_hz))
