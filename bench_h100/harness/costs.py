"""The H100's published peaks and a kernel's share of its roofline.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit:
3.35 TB/s of HBM3, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
on the CUDA cores (TF32 off). A kernel metric's file gives its function's
operations and bytes per call from the call's shapes (each operand read
once, each output written once, at the crystals' real, masked-in edges
and nodes: padding is not work the inputs need); its share is the least
time those need, the larger of operations over the peak rate and bytes
over the bandwidth, summed over the calls of the traced stretch, over the
device time of the kernels its CUDA-name patterns match."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype]


def roofline(r, patterns, call: str, cost) -> float | None:
    """% of the roofline over the traced stretch: ``patterns`` match the
    kernels' CUDA names, ``call`` one kernel a call, ``cost(step, model,
    dtype) -> (ops, bytes)`` one call's work at a step's counts. The calls
    are spread evenly over the stretch's steps: the mean bound of a call
    times the calls caught, over their device time (a capture that lost a
    few events loses their time and their calls alike). None where the
    trace has no such kernel."""
    t = r.trace
    if t is None or not t.steps:
        return None
    seconds = t.seconds(patterns)
    calls = t.count(call)
    if seconds <= 0 or calls == 0:
        return None
    dtype = r.config["model"]["compute_dtype"]
    bound = 0.0
    for step in t.steps:
        ops, nbytes = cost(step, r.config["model"], dtype)
        bound += max(ops / PEAK_OPS_PER_S[dtype], nbytes / PEAK_BYTES_PER_S)
    return 100.0 * bound / len(t.steps) * calls / seconds
