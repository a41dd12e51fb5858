"""Compute ops of the port: norms, rotary, embedding, and the two kernel
families written by hand for Hopper: flash attention and the fused lm-head
cross-entropy (with the chunked cross-entropy behind
``DLROVER_TPU_FUSED_CE=0``)."""

from dlrover_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
    mha_reference,
    mha_reference_with_lse,
)
from dlrover_tpu_torch.ops.chunked_ce import (  # noqa: F401
    chunked_ce_enabled,
    chunked_cross_entropy,
)
from dlrover_tpu_torch.ops.embedding import embed_lookup  # noqa: F401
from dlrover_tpu_torch.ops.fused_ce import (  # noqa: F401
    cross_entropy_sums,
    fused_ce_enabled,
    fused_cross_entropy,
)
from dlrover_tpu_torch.ops.norms import rms_norm  # noqa: F401
from dlrover_tpu_torch.ops.rotary import apply_rope, rope_frequencies  # noqa: F401
