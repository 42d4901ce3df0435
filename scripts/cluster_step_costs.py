#!/usr/bin/env python3
"""What one step of B1's cluster-route backward costs, part by part, on one
CUDA card, measured on variants of the kernel's own source.

    python3 scripts/cluster_step_costs.py

Each variant is `vlnce_torch/csrc/gru_sequence.cu` with a few lines of
`gru_sequence_backward_cluster_kernel` replaced (VARIANTS below). Every
replaced text must occur exactly once in the source, so an edit of those
lines stops the script with the text it no longer finds instead of timing
code the kernel no longer runs. The variants are built with nvcc at once
(into the git-ignored vlnce_torch/build/), each called through its C entry
`gru_sequence_backward_cluster_f32` at the training shape (B=5, H=512, the
cluster the plan grants) at T = 1, 32 and 48, in two rounds of opposite
order, timed by CUDA-graph replay. Per step is (T=48 - T=1) / 47. The
variants that keep the function are held against the plain backward first.
Then the SM clock while the kernel runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_ms  # noqa: E402
from vlnce_torch.ops import _build  # noqa: E402
from vlnce_torch.ops.rnn import _ARGTYPES, gru_sequence_backward_plain, gru_sequence_plain  # noqa: E402

B, H, STEPS = 5, 512, (1, 32, 48)

SUMS = ("dh += m_next[s] * (dhz[s] + cluster_sum((t + 1) & 1, b, j));", "dh += m_next[s] * dhz[s];")
PRODUCT = ("for (int row = 0; row < kGroupRows; row += 4) {", "for (int row = 0; row < 0; row += 4) {")
# the step's only cluster barrier becomes a block barrier; without remote
# sums nothing reads another block's memory but d_h0's sum, which goes too
BARRIER = [("    cluster_arrive();\n", "    __syncthreads();\n"), ("    cluster_wait();\n", ""),
           ("m_next[s] * (dhz[s] + cluster_sum(0, b, j))", "m_next[s] * dhz[s]")]
# each block tells every block by an mbarrier arrival in its shared memory
# that its part of a plane is in, and waits on its own plane's mbarrier
# before it sums the plane, in place of the cluster barrier
MBARRIER = [
    ("const long long bytes = 16 + 4LL", "const long long bytes = 32 + 4LL"),
    ("  float* w_s = reinterpret_cast<float*>(smem + 16);\n  float* planes",
     "  uint64_t* plane_ready = reinterpret_cast<uint64_t*>(smem + 16);\n"
     "  float* w_s = reinterpret_cast<float*>(smem + 32);\n  float* planes"),
    ("  if (tid == 0) start_w_copies(w_arrived, w_s, w_hh, unit0, units, units, H);\n",
     "  if (tid == 0) {\n"
     "    start_w_copies(w_arrived, w_s, w_hh, unit0, units, units, H);\n"
     "    async_copy::barrier_init(plane_ready, blocks);\n"
     "    async_copy::barrier_init(plane_ready + 1, blocks);\n"
     "  }\n"
     "  cluster.sync();\n"
     "  auto wait_plane = [&](int s) {\n"
     "    const uint32_t bar = async_copy::shared_address(plane_ready + (s & 1));\n"
     "    const uint32_t parity = (uint32_t)(((T - 1 - s) / 2) & 1);\n"
     "    uint32_t done;\n"
     "    do {\n"
     "      asm volatile(\"{\\n.reg .pred p;\\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\\n"
     "selp.u32 %0, 1, 0, p;\\n}\" : \"=r\"(done) : \"r\"(bar), \"r\"(parity) : \"memory\");\n"
     "    } while (!done);\n"
     "  };\n"),
    ("    // dh of the owned pairs, then the gradients of their gates\n",
     "    if (t + 1 < T) wait_plane(t + 1);\n"),
    ("    cluster_arrive();\n",
     "    __syncthreads();\n"
     "    if (tid < blocks) {\n"
     "      uint32_t remote;\n"
     "      asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\" : \"=r\"(remote)\n"
     "                   : \"r\"(async_copy::shared_address(plane_ready + (t & 1))), \"r\"(tid));\n"
     "      asm volatile(\"mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\" :: \"r\"(remote) : \"memory\");\n"
     "    }\n"),
    ("    cluster_wait();\n", ""),
    ("  // d_h0 from the parts of step 0", "  wait_plane(0);\n  // d_h0 from the parts of step 0"),
]
# the first 24 of a product thread's 48 rows of w_hh held in registers for
# the whole launch, read from shared memory once
REGISTERS = [
    ("constexpr int kGroupRows = 48;", "constexpr int kRegisterRows = 24;\nconstexpr int kGroupRows = 48;"),
    ("const float4* w4 = reinterpret_cast<const float4*>(w_s) + quad;  // rows H / 4 float4 apart",
     "const float4* w4 = reinterpret_cast<const float4*>(w_s) + quad;\n  float4 w_regs[kRegisterRows];"),
    ("    if (t == T - 1) async_copy::barrier_wait(w_arrived, 0);\n",
     "    if (t == T - 1) {\n"
     "      async_copy::barrier_wait(w_arrived, 0);\n"
     "      if (quad < quads)\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < kRegisterRows; ++i) w_regs[i] = w4[(size_t)(first + i) * quads];\n"
     "    }\n"),
    ("for (int i = 0; i < 4; ++i) w[i] = w4[(size_t)(first + row + i) * quads];",
     "for (int i = 0; i < 4; ++i) w[i] = row + i < kRegisterRows ? w_regs[row + i] : w4[(size_t)(first + row + i) * quads];"),
]

# name: (what it keeps, the replacements, whether it still computes the gradient)
VARIANTS = {
    "kernel": ("the kernel as it is", [], True),
    "mbarrier": ("remote mbarrier arrivals in place of the cluster barrier", MBARRIER, True),
    "registers": ("24 rows of w_hh per product thread in registers", REGISTERS, True),
    "mbarrier_registers": ("both of the above", MBARRIER + REGISTERS, True),
    # 16 distinct columns of the row, so that no two loads merge; the route
    # takes H a power of two
    "local_sums": ("the 16 loads per owned value from the block's own shared memory",
                   [("cluster.map_shared_rank(planes, c)[((size_t)p * kB + b) * H + j]",
                     "planes[((size_t)p * kB + b) * H + ((j + 32 * c) & (H - 1))]")], False),
    "no_sums": ("no sums of the cluster's parts", [SUMS], False),
    "no_product": ("no product d_gh . w_hh", [PRODUCT], False),
    "floor": ("neither sums nor product: the barrier, the gates' gradients, loads and stores", [SUMS, PRODUCT], False),
    "floor_no_barrier": ("the floor with __syncthreads in place of the cluster barrier", [SUMS, PRODUCT] + BARRIER, False),
}


def variant_source(source: str, name: str, replacements) -> str:
    for old, new in replacements:
        if source.count(old) != 1:
            raise SystemExit(f"cluster_step_costs: variant {name}: {old!r} occurs {source.count(old)} times in "
                             "gru_sequence.cu, not once: bring VARIANTS up to date with the kernel")
        source = source.replace(old, new)
    return source


def build(names):
    """{name: C entry of the cluster route}, every variant's nvcc at once."""
    with open(os.path.join(_build.CSRC_DIR, "gru_sequence.cu")) as f:
        source = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(_build.BUILD_DIR, f"cluster_step_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(source, name, VARIANTS[name][1]))
        lib = os.path.join(_build.BUILD_DIR, f"libcluster_step_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"cluster_step_costs: nvcc failed for variant {name}:\n{log.decode(errors='replace')}")
        fn = ctypes.CDLL(lib).gru_sequence_backward_cluster_f32
        fn.argtypes, fn.restype = _ARGTYPES["gru_sequence_backward_cluster_f32"], ctypes.c_int
        entries[name] = fn
    return entries


def inputs(T, dev, g):
    xi = torch.randn(T, B, 3 * H, generator=g)
    masks = torch.ones(T, B, 1)
    masks[T // 2, ::2] = 0.0
    h0 = torch.randn(B, H, generator=g)
    w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
    b_hh = torch.randn(3 * H, generator=g) * 0.1
    d_out = torch.randn(T, B, H, generator=g)
    xi, masks, h0, w_hh, b_hh, d_out = (t.to(dev) for t in (xi, masks, h0, w_hh, b_hh, d_out))
    out, gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
    ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates)
    return d_out, gates, masks, h0, w_hh, out, ref


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_step_costs: no CUDA card visible", file=sys.stderr)
        return 1
    from vlnce_torch.ops.rnn import backward_cluster_plan

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cluster = backward_cluster_plan(dev.index, B, H)[0]
    assert cluster, "the cluster route does not take B=5, H=512 on this card"
    t0 = time.perf_counter()
    entries = build(VARIANTS)
    print(f"{len(entries)} variants of gru_sequence.cu built in {time.perf_counter() - t0:.1f} s; cluster of {cluster}")
    g = torch.Generator().manual_seed(3)
    cases = {T: inputs(T, dev, g) for T in STEPS}

    def call(fn, T):
        d_out, gates, masks, h0, w_hh, out, _ = cases[T]
        d_xi, d_h0 = torch.empty(T, B, 3 * H, device=dev), torch.empty(B, H, device=dev)
        d_gh = torch.empty_like(d_xi)

        def launch():
            _build.check("cluster variant", fn(d_out.data_ptr(), gates.data_ptr(), masks.data_ptr(), h0.data_ptr(),
                                               h0.stride(0), w_hh.data_ptr(), out.data_ptr(), d_xi.data_ptr(),
                                               d_h0.data_ptr(), d_gh.data_ptr(), T, B, H, cluster,
                                               torch.cuda.current_stream().cuda_stream))
        return launch, (d_xi, d_h0)

    for name, (_, _, exact) in VARIANTS.items():
        if not exact:
            continue
        for T in STEPS:
            launch, got = call(entries[name], T)
            launch()
            torch.cuda.synchronize()
            for label, a, b in zip(("d_xi", "d_h0"), got, cases[T][-1][:2]):
                err = float((a - b).abs().max())
                assert err <= 1e-5 * max(1.0, float(b.abs().max())), f"variant {name} T={T} {label}: {err}"
        print(f"variant {name} matches the plain backward at T in {STEPS} (d_xi, d_h0 within 1e-5 x max(1, scale))")

    times = {}
    for rnd in range(2):
        for name in list(VARIANTS)[:: 1 if rnd == 0 else -1]:
            for T in STEPS:
                times.setdefault((name, T), []).append(graph_ms(call(entries[name], T)[0]))
    for name, (what, _, _) in VARIANTS.items():
        best = {T: min(times[(name, T)]) for T in STEPS}
        print(f"{name} ({what}): T=1 {best[1]:.4f} ms, T=32 {best[32]:.4f} ms (rounds "
              + ", ".join(f"{ms:.4f}" for ms in times[(name, 32)])
              + f"), T=48 {best[48]:.4f} ms; per step {(best[48] - best[1]) / 47 * 1e3:.3f} us")

    # the SM clock while the kernel runs
    launch, _ = call(entries["kernel"], 48)
    smi = subprocess.Popen(["bash", "-c", "sleep 0.3; nvidia-smi --query-gpu=clocks.sm,clocks.max.sm,power.draw --format=csv,noheader"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(50):
            launch()
        torch.cuda.synchronize()
    print(f"SM clock, max clock, power under the kernel at T=48: {smi.communicate()[0].strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
