"""The arithmetic chain's one public instance: offset + sum of
(x_i * y_i + r_i) mod p."""

from __future__ import annotations

from ...natives.poseidon import FR_P


def expected_instances(config: dict, inp: dict) -> list[int]:
    acc = config["offset"]
    for x, y, r in zip(inp["x"], inp["y"], inp["r"]):
        acc = (acc + x * y + r) % FR_P
    return [acc]
