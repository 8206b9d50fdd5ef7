"""Evaluation tooling: WER, text normalization, the manifest runner.

Port of ``whisper_burn_tpu/eval`` (``wer``, ``english_normalizer``,
``runner``). Its accuracy tools (``quant_accuracy``, ``hf_oracle``) are
not ported yet (ROADMAP).
"""

from whisper_burn_tpu_torch.eval.wer import normalize_text, wer, word_errors

__all__ = ["wer", "word_errors", "normalize_text"]
