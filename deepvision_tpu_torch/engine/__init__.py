"""Serving engine: tokenizer -> scheduler -> paged prefill/decode on CUDA.

Entry point: :class:`deepvision_tpu_torch.engine.engine.LLMEngine`.
"""
