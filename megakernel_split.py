"""Where a block of the ghost-BN bottleneck megakernel spends its time,
and how deep its bfloat16 sums may run before they are promoted.

Builds copies of ``paddle_tpu_torch/csrc/block_megakernel.cu``, each with
the string edits of one entry of VARIANTS, into
``build/megakernel_split/<variant>/`` (one nvcc each, all started
together) and, for each copy, on the card:

  * holds the roll micro's ``full`` and ``nobn`` variants (stage 2,
    batch 128, tile 2, bfloat16, 8 blocks, chip_smoke.py phase 12's
    inputs) against their plain twins: the 8-block 2-norm gap over
    phase 12's limit (the twin's own distance from the float32 chain);
  * profiles the megakernel chain at stage 2 (bfloat16, tile 2) and
    stage 4 (bfloat16, tile 1): device ms a block by kernel role
    (chip_smoke.py's ``mega_role``).

Variants:

  kernel           the source as it is
  promote_bf16_32  bfloat16 reduction steps promoted past 32 multiplies
                   into one accumulator (the source: past 16)
  promote_bf16_96  past 96, float32's depth
  no_prologue      the 3x3 without BN1's in-place prologue
  no_statistics    no statistics partials in any epilogue
  no_products      no bfloat16 multiplies

The last three compute wrong values on purpose: they are timed only (the
holds are skipped). A measurement of the design, not a route of any op.
Run on a machine with the card and nvcc, from the repository root:

    python3 megakernel_split.py

tests/test_torch_block_megakernel_cuda_source.py holds every variant's
edits against the current source on the CPU.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "paddle_tpu_torch" / "csrc" / "block_megakernel.cu"
OUT = ROOT / "build" / "megakernel_split"

_PROMOTE = """  const bool promote = p.n_it * 4 * (E::kBf16 ? 1 : 3) >
                       (E::kBf16 ? kPromoteAfterBf16 : kPromoteAfter);"""

#: variant: ((old, new), ...) string edits of the source, each old
#: occurring exactly once
VARIANTS = {
    "kernel": (),
    "promote_bf16_32": ((_PROMOTE, _PROMOTE.replace("kPromoteAfterBf16",
                                                    "32")),),
    "promote_bf16_96": ((_PROMOTE, _PROMOTE.replace("kPromoteAfterBf16",
                                                    "96")),),
    "no_prologue": (("      activate(o, j, slab, cur, av, bv);\n", ""),),
    "no_statistics": (
        ("  if (kEpi != kResidual && p.partial != nullptr) {",
         "  if (false) {"),),
    "no_products": (
        ("            sm90::wgmma<kBN, true>(d, af[ks], btile + ks * 32, "
         "ks | keep);", "            (void)keep;"),),
}
#: the variants whose outputs are right (held against the twins)
HELD = ("kernel", "promote_bf16_32", "promote_bf16_96")


def edited(name: str, text: str) -> str:
    """The source `text` with the edits of VARIANTS[name]."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: edit anchor found {text.count(old)} "
                             f"times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_all():
    """Every variant's library, compiled in parallel: {name: CDLL}."""
    from paddle_tpu_torch.ops.kernels import block_megakernel as bm
    from paddle_tpu_torch.ops.kernels import build
    text = SOURCE.read_text()
    procs = {}
    for name in VARIANTS:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for header in SOURCE.parent.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / SOURCE.name).write_text(edited(name, text))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / SOURCE.name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = bm.bind(ctypes.CDLL(str(OUT / name / "lib.so")))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("megakernel_split: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import block_megakernel as bm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    libs = build_all()

    # phase 12's inputs, and the twins' chains the holds compare with
    label, n, cin, cm, side = cs.MEGA_STAGES[0]
    gen = torch.Generator(device=cs.DEVICE).manual_seed(19)
    x32, p32 = cs._mega_inputs(gen, n, side, cin, cm, cs.MEGA_BLOCKS, False)
    xm = x32.to(torch.bfloat16).reshape(n * side * side, cin)
    pm = cs._cast(p32, "bf16")
    twins = {}
    for variant in ("full", "nobn"):
        twin = cs.micro_chain(xm, pm, variant, side, 2, True)
        twins[variant] = (twin, cs._norm_limit("bf16", twin, cs.micro_chain(
            xm.float(), cs._cast(pm, "f32"), variant, side, 2, True)))
    # phase 11's inputs at stages 2 and 4, two blocks
    chains = {}
    for stage, tile in (("stage2", 2), ("stage4", 1)):
        _, n_, cin_, cm_, side_ = [s for s in cs.MEGA_STAGES
                                   if s[0] == stage][0]
        g = torch.Generator(device=cs.DEVICE).manual_seed(17)
        xx, pp = cs._mega_inputs(g, n_, side_, cin_, cm_, 2, False)
        chains[stage] = (xx.to(torch.bfloat16), cs._cast(pp, "bf16"), side_,
                         tile)

    for name, lib in libs.items():
        bm._library = lambda lib=lib: lib
        if name in HELD:
            holds = []
            for variant, (twin, limit) in twins.items():
                gap = cs._gaps(cs.micro_chain(xm, pm, variant, side, 2),
                               twin)[2]
                holds.append(f"{variant} {gap:.3e} / limit {limit:.3e} = "
                             f"{gap / limit:.3f}")
            print(f"[{card}] {name}: roll micro after {cs.MEGA_BLOCKS} "
                  f"blocks, 2-norm gap / limit: " + "; ".join(holds),
                  flush=True)
        for stage, (x, params, sd, tile) in chains.items():
            cs.profile_chain(card, lambda: cs.mega_chain(x, params, sd, tile),
                             len(params), f"{name} {stage} bf16 tile {tile}",
                             cs.mega_role)
    return 0


if __name__ == "__main__":
    sys.exit(main())
