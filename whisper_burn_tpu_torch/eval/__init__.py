"""Evaluation tooling: WER, text normalization, the manifest runner, and
the accuracy tools.

Port of ``whisper_burn_tpu/eval``: ``wer``, ``english_normalizer``,
``runner``, ``quant_accuracy`` (teacher-forced agreement of the quantized
serving modes against an f32 reference, and their floors) and
``hf_oracle`` (token parity against HuggingFace ``generate()``), each
imported from its module.
"""

from whisper_burn_tpu_torch.eval.wer import normalize_text, wer, word_errors

__all__ = ["wer", "word_errors", "normalize_text"]
