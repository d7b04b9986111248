"""Issue-rate probes of the card: the counterparts of the JAX package's
TPU microbenchmarks `scripts/mosaic_probe.py` (P1) and
`scripts/mosaic_probe2.py` (P2), as hand-written CUDA kernels
(`csrc/probes.cu`) beside their plain PyTorch versions.

    python3 -m cuclarabel_torch.probes.mosaic_probe [N] [B]
    python3 -m cuclarabel_torch.probes.mosaic_probe2

P1 asks whether a streaming elementwise kernel overlaps instruction issue
with memory traffic; P2 how many values a thread carries through a
dependent chain before they spill from registers, and what a spill
costs.  No solve path runs them.  Launches and plain calls are counted
in `kkt.ldl.LAUNCHES` and `kkt.ldl.PLAIN_CALLS` under "probe_chain/<v>"
and "probe_issue/R<R>s<streams>".
"""
