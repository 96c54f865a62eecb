"""Operations and bytes of the grouped expert GEMM (``csrc/moe_gemm.cu``,
``moe_expert_kernel``: the gate/up launch and the down launch of every
expert layer) over a traced slice.

Weights: each expert layer dispatch reads the gate, up and down weights of
the experts that got a row, once (3 d F bf16 values each); an expert no
row reached is never counted. The engine counts the experts reached on the
device (``payload()["moe"]``), read when the window opens and closes: so
the slice's count is the window's mean per dispatch times the slice's
expert-layer dispatches (layers times its decode steps and chunks).
Activations: each assignment (a row's k choices of the live rows: a decode
step's rows, a chunk's valid rows) reads its row into gate/up and writes
the two outputs, reads the SwiGLU's row into down and writes its output.
Operations: 2 x assignments x 3 d F. The least time is the larger of the
bytes at the memory rate and the operations at the bf16 peak, summed over
the slice first (never more than the sum over dispatches).
"""

from __future__ import annotations

KERNEL_MATCH = ("moe_expert_kernel",)


def touched_per_dispatch(c0: dict, c1: dict) -> float | None:
    """The window's experts reached per expert-layer dispatch, from the
    engine's counters at its opening and closing (None without them)."""
    m0, m1 = (c0 or {}).get("moe"), (c1 or {}).get("moe")
    if not m0 or not m1 or m1["dispatches"] <= m0["dispatches"]:
        return None
    return ((m1["experts_touched"] - m0["experts_touched"])
            / (m1["dispatches"] - m0["dispatches"]))


def slice_rows(acc) -> int:
    """The live rows the slice's expert layers routed, per layer."""
    if acc.chunks is not None:
        return acc.decode_rows + sum(valid for _, valid in acc.chunks)
    return acc.decode_rows + acc.chunk_dispatches * acc.chunk_width


def least_seconds(cfg, acc, peaks: dict, c0: dict, c1: dict,
                  elt: int = 2) -> float | None:
    touched = touched_per_dispatch(c0, c1)
    if touched is None:
        return None
    d, ff, L, k = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.experts_per_token
    layer_dispatches = L * (acc.decode_dispatches + acc.chunk_dispatches)
    assignments = L * k * slice_rows(acc)
    nbytes = (touched * layer_dispatches * 3 * d * ff
              + assignments * (2 * d + 3 * ff)) * elt
    ops = 2 * assignments * 3 * d * ff
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["bf16_flops"])
