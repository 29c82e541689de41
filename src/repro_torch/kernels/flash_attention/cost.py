"""What one launch of the flash-attention kernels costs: the FLOPs of the
products and of the softmax, and the bytes they must move (each input
read once, each output written once), from the shapes.  ``chip_smoke.py``
divides them by the card's rates for each kernel's bound (the products
either in fp32 or as 3xTF32 on the tensor cores); counters
(:mod:`repro_torch.kernels._cost`) add them up per launch."""
from __future__ import annotations


def visible_pairs(S: int, Sk: int, causal: bool, window: int | None,
                  key_offset: int = 0) -> int:
    """Query-key pairs of one head that the masks let through: query s sees
    keys ``max(0, s - window + 1) .. min(s, Sk - 1)`` when causal or
    windowed (``Sk`` is then ``S``), every key otherwise.  A causal key
    shard (keys at positions ``key_offset ...``, no window) is seen from
    query ``key_offset`` on, as the whole sequence's keys are by the
    queries after it."""
    if not causal and window is None:
        return S * Sk
    if key_offset:
        S = max(0, S - key_offset)
    m = min(S, Sk)                        # query s < m sees s + 1 keys, a later one Sk
    seen = m * (m + 1) // 2 + max(0, S - Sk) * Sk
    if window is None or window >= S:
        return seen
    cut = S - window                      # queries window .. S - 1 lose s - window + 1 keys
    return seen - cut * (cut + 1) // 2


def flash_cost(B: int, S: int, Sk: int, H: int, KV: int, hd: int, dv: int | None = None,
               causal: bool = True, window: int | None = None, itemsize: int = 4,
               lse: bool = False, key_offset: int = 0) -> tuple[int, int, int]:
    """``(product flops, softmax flops, bytes)`` of a forward launch: each
    visible pair is 2·hd flops for q·k, 2·dv for p·v and about 4 for the
    softmax (``dv`` is v's width, hd by default); q and the output move
    once (S rows of H heads), k and v once (Sk rows of KV heads); ``lse``
    adds each row's log-sum-exp written in fp32 (the forward under grad)."""
    dv = hd if dv is None else dv
    pairs = B * H * visible_pairs(S, Sk, causal, window, key_offset)
    nbytes = itemsize * B * (hd + dv) * (S * H + Sk * KV) + (4 * B * H * S if lse else 0)
    return pairs * 2 * (hd + dv), pairs * 4, nbytes


def flash_backward_cost(B: int, S: int, Sk: int, H: int, KV: int, hd: int, causal: bool = True,
                        window: int | None = None, itemsize: int = 4,
                        key_offset: int = 0) -> tuple[int, int, int]:
    """``(product flops, softmax flops, bytes)`` of a backward launch (its
    two kernels): q, out, dout read and dq written (S rows of H heads), k
    and v read and dk, dv written (Sk rows of KV heads), each once; five
    products of 2·hd flops per visible pair (q·k, dout·v, dq, dk, dv) and
    about 4 for the softmax and dS."""
    pairs = B * H * visible_pairs(S, Sk, causal, window, key_offset)
    return pairs * 5 * 2 * hd, pairs * 4, itemsize * B * hd * (4 * S * H + 4 * Sk * KV)
