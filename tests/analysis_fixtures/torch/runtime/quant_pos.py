"""NOS024 positives for the PyTorch rules: scale-state writes outside the
ops/ funnel — a subscript assignment, the in-place methods (index_copy_,
scatter_reduce_, fill_ on an element, mul_, zero_), a del, the engine's
`_kv_scales` attribute assignment — and both dequantization calls."""


def write_scales(cache, b, s):
    cache["0"]["k_scale"][b] = s  # NOS024
    cache["0"]["v_scale"].index_copy_(0, b, s)  # NOS024
    cache["1"]["k_scale"].scatter_reduce_(0, b, s, "amax")  # NOS024
    cache["1"]["v_scale"][b].fill_(1.0)  # NOS024
    cache["2"]["k_scale"].mul_(2.0)  # NOS024
    del cache["2"]["v_scale"]  # NOS024


class Engine:
    def reset(self):
        self._kv_scales = None  # NOS024
        self._kv_scales.zero_()  # NOS024

    def hydrate(self, tier, b):
        return tier.dequantize_block(b)  # NOS024


def widen(codes, scales):
    return dequantize(codes, scales)  # NOS024
