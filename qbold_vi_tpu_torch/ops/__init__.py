"""Kernel wrappers with their plain torch versions."""

__all__ = ["launch_counts"]


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter in this process (kernel ->
    launches): what a rank of a sharded run reports of its kernels."""
    from . import (conv3x3, decode_nll, fused_elbo, fused_infer, quadrature,
                   summarize, synth_batch)

    h, fi, sm = conv3x3.conv3x3, fused_infer, summarize
    return {
        "A": quadrature.quad_posterior_summaries.launches,
        "B": fi.encode_quad_fused.launches,
        "B_bf16": fi.encode_quad_fused.bf16_launches,
        "C": fi.encode_q1_packed.launches,
        "C_bf16": fi.encode_q1_packed.bf16_launches,
        "D": sm.mc_posterior_summaries.launches,
        "D_packed": sm.mc_posterior_summaries_packed.launches,
        "E": sm.mc_kl_map.launches,
        "F_fwd": fused_elbo.fused_elbo_forward.launches,
        "F_bwd": fused_elbo.fused_elbo_backward.launches,
        "G_fwd": decode_nll.decode_nll_forward.launches,
        "G_bwd": decode_nll.decode_nll_backward.launches,
        "H_fwd": h.fwd_launches, "H_bwd": h.bwd_launches,
        "H_bf16_fwd": h.fwd_bf16_launches, "H_bf16_bwd": h.bwd_bf16_launches,
        "S": synth_batch.synth_batch.launches,
    }
