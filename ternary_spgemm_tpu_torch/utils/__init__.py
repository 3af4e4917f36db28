from ternary_spgemm_tpu_torch.utils.shapes import cdiv, pad_to, round_up

__all__ = ["cdiv", "round_up", "pad_to"]
