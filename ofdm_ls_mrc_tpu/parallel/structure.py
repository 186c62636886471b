"""Compiled-program structure checks for the sharded receiver.

BASELINE.json metric 2's structural contract: the antenna-sharded demod
step must contain EXACTLY ONE all-reduce, carrying the fused
(num_re, num_im, sum|H|^2) tuple of (2*S_local + 1) * F fp32 words -- a
payload INDEPENDENT of the antenna-shard count, because antennas reduce
locally before the collective (the distributed form of the reference's
intra-GPU antenna tree-reduce, gpuLS.cu:198-203,247-252).  These helpers
read that structure off the compiled HLO so the dryrun
(``__graft_entry__.dryrun_multichip``), the scaling harness
(``tools/scaling_bench.py``) and ``chip_smoke.py --multi`` can assert or
record it rather than re-derive it from prose.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def collective_signature(compiled_text: str) -> Tuple[int, int]:
    """(all_reduce_count, payload_fp32_words) read off compiled HLO text.

    The single parse shared by the dryrun assertions, the scaling harness,
    chip_smoke.py and tests -- fix payload accounting here, nowhere else.
    The GPU compiler splits each all-reduce into an async
    ``all-reduce-start`` / ``all-reduce-done`` pair: the start is counted.
    """
    op = re.compile(r"=.*?\ball-reduce(?:-start)?\(")
    elems = 0
    count = 0
    for ln in compiled_text.splitlines():
        m = op.search(ln)
        if m is None:
            continue
        count += 1
        sig = ln[:m.end()].rsplit("all-reduce", 1)[0]
        elems += sum(int(np.prod([int(d) for d in dims.split(",")]))
                     for dims in re.findall(r"f32\[([0-9,]+)\]", sig))
    return count, elems


def fused_psum_signature(rx, frame: np.ndarray) -> Tuple[int, int]:
    """Compile the sharded split-entry demod step and read its collective
    structure.

    Args:
      rx:    a ``ShardedUplinkReceiver``.
      frame: host complex64 ``[S, A, symbol_len]`` example frame.

    Returns:
      (all_reduce_count, payload_fp32_words): the number of all-reduce ops
      in the compiled HLO and the total fp32 words they carry.
    """
    from ..ops.cplx import CArray

    c = CArray.from_numpy(frame)
    txt = rx._demod.lower(c[0], c[1:], rx.x_full).compile().as_text()
    return collective_signature(txt)


def expected_psum_payload_words(cfg, time_shards: int = 1) -> int:
    """(2*S_local + 1) * F fp32 words: numerator re+im per local data symbol
    plus one shared |H|^2 row."""
    s_local = cfg.num_data_symbols // time_shards
    return (2 * s_local + 1) * cfg.fft_size


def assert_single_fused_psum(rx, frame: np.ndarray, cfg,
                             time_shards: int = 1) -> None:
    """Assert the compiled step has exactly one all-reduce with the expected
    fused payload (used by dryrun_multichip on every driver run)."""
    count, elems = fused_psum_signature(rx, frame)
    assert count == 1, f"expected exactly one fused all-reduce, found {count}"
    want = expected_psum_payload_words(cfg, time_shards)
    assert elems == want, (
        f"psum payload {elems} fp32 words != expected {want} "
        f"((2*{cfg.num_data_symbols // time_shards}+1)*{cfg.fft_size})")
