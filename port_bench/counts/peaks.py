"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at
the full power limit of 700 W): the tensor cores in bfloat16, FFMA in float32
(the program keeps TF32 off), and HBM3."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
IO_BYTES = {"bfloat16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations at the dtype's peak or
    bytes at the memory's rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)
