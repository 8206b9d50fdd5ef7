"""The operation and byte counts agree with counts made by hand at the
port's ``tiny_test()`` sizes (d 64, 2 heads, FFN 256, 12 audio frames,
8 mels, 2 + 2 layers, vocab 51865)."""

import pytest

from benchmark import flops, harness, model_config, trace

S = model_config.tiny_shape()
WHISPER = harness.family_module("whisper")


def test_encoder_operations_by_hand():
    stem = 2 * 24 * 8 * 3 * 64 + 2 * 12 * 64 * 3 * 64  # conv1 over 24 frames, conv2 (stride 2) to 12
    layer = 2 * 12 * 64 * 256 + 4 * 12 * 12 * 64 + 4 * 12 * 64 * 256  # q, k, v, o; scores and values; FFN
    assert flops.encoder_flops(S) == stem + 2 * layer


def test_request_operations_by_hand():
    def token(pos, logits):
        layer = 2 * 64 * 192 + 4 * (pos + 1) * 64 + 2 * 64 * 64 + 2 * 64 * 64 + 4 * 12 * 64 + 2 * 64 * 64 + 4 * 64 * 256
        return 2 * layer + (2 * 64 * 51865 if logits else 0)

    base = flops.encoder_flops(S) + 2 * 2 * 12 * 64 * 128  # the cross fill's k and v
    prompt = token(0, False) + token(1, False) + token(2, False) + token(3, True)
    assert flops.request_flops(S, 3) == pytest.approx(base + prompt + token(4, True) + token(5, True))
    beam = base + prompt + 5 * (token(4, True) + token(5, True))
    assert flops.request_flops(S, 3, beam_width=5) == pytest.approx(beam)
    detect = token(0, False) + 2 * 64 * 99
    assert flops.request_flops(S, 3, detect=True) == pytest.approx(base + prompt + detect + token(4, True) + token(5, True))


@pytest.mark.parametrize("kernel, shape, pos, want", [
    # x bf16, codes a byte each, f32 block scales, f32 bias, bf16 out
    ("q4_matmul", (4, 64, 192, 1), None, (4 * 64 * 2 + 64 * 192 + 2 * 192 * 4 + 192 * 4 + 4 * 192 * 2, 2 * 4 * 64 * 192)),
    # the int8 logits: the vocab padded to 512, f32 out, no bias
    ("q4_matmul", (2, 64, 52224, 0), None, (2 * 64 * 2 + 64 * 52224 + 2 * 52224 * 4 + 2 * 52224 * 4, 2 * 2 * 64 * 52224)),
    ("fused_ffn", (2, 64, 256, 1), None,
     (2 * 2 * 64 * 2 + 2 * 64 * 256 + 2 * 256 * 4 + 8 * 64 * 4 + 256 * 4 + 64 * 4, 4 * 2 * 64 * 256)),
    ("decode_self_attention", (2, 64, 64), 5,
     (2 * (128 + 2 * 5 * 64 + 40 + 256 + 128 + 8 + 256 + 128 + 8), 4 * 2 * 6 * 64)),
    ("decode_attention_layer", (10, 64, 64), 5, (10 * (128 + 640 + 40 + 256 + 16), 4 * 10 * 5 * 64)),
    ("decode_cross_attention", (10, 16, 64, 5), None, (10 * 128 + 2 * 32 * 12 + 2 * 6 * 64 + 10 * 256, 4 * 10 * 12 * 64)),
    ("decode_cross_attention_unpacked", (2, 16, 64, 1, 1), None, (2 * 128 + 2 * 2 * 64 * 12 + 2 * 256, 4 * 2 * 12 * 64)),
    ("encoder_attention", (2, 128, 64), None, (4 * 2 * 12 * 64 * 2, 4 * 2 * 12 * 12 * 64)),
    ("write_cache_slot", (2, 3, 64, 64, 64, 8), None, (2 * 2 * 3 * 136, 0)),
    ("write_cache_slot_beam", (2, 10, 64, 64, 64, 8), 5, (2 * 136 * (10 * 6 + 10 + 5), 0)),
])
def test_kernel_bytes_and_operations_by_hand(kernel, shape, pos, want):
    assert trace.bound_module(kernel).bound(shape, pos, WHISPER.kernel_dims(S)) == want


def test_positions_follow_the_launch_order():
    assert S.decoder_layers == 2
    assert WHISPER.positions(S, list(range(6)), "layer") == [4, 4, 5, 5, 6, 6]
    assert WHISPER.positions(S, list(range(3)), "step") == [4, 5, 6]
    assert WHISPER.positions(S, list(range(2)), None) == [None, None]


def test_lost_records_are_walked_past():
    ev = lambda grid, dur: {"name": "k", "grid": grid, "dur": dur}
    logged = ["a", "b", "a", "b"]
    durs, lost, whole = trace.match_launches([ev("1", 1.0), ev("2", 2.0), ev("2", 4.0)], logged)
    assert durs == [1.0, 2.0, None, 4.0] and lost == 1 and whole
