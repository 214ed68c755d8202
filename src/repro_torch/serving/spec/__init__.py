"""Entropy-guided self-speculative decoding.

The quantized model drafts for itself: an entropy-ordered all-int4 variant
of the served weights (``quant.compiler.compile_draft_plan``; blocks the
plan already pushed to int4 share their tensors) proposes K tokens per
round, the mixed-precision target scores the whole window in one
multi-query decode step, accepts the longest matching prefix and rolls the
KV cache back by position arithmetic.
"""

from repro_torch.serving.spec.loop import (SpecConfig, SpecMetrics,
                                           make_spec_round, spec_round)

__all__ = ["SpecConfig", "SpecMetrics", "make_spec_round", "spec_round"]
