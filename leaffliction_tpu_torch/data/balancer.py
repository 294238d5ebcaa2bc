"""Class-balancing plan.

Copy of the plan of `leaffliction_tpu/data/balancer.py`: per plant, each
class's deficit to the plant's largest class, split evenly over the six
transforms with the remainder to the first ones. The port executes the plan
on the device (`data/fused_balance.py`); the JPEG-materialising
`DatasetBalancer` is not ported.
"""

from __future__ import annotations

from typing import Dict

TRANSFORMATIONS = ("flip", "rotate", "skew", "shear", "crop", "distortion")


def calculate_plan(counts: Dict[str, Dict[str, int]]
                   ) -> Dict[str, Dict[str, int]]:
    """class → {transform: count}; deficit split //6 with remainder to the
    first transforms."""
    deficits: Dict[str, int] = {}
    for _plant, classes in counts.items():
        plant_max = max(classes.values())
        for class_name, count in classes.items():
            deficit = plant_max - count
            if deficit > 0:
                deficits[class_name] = deficit
    plan: Dict[str, Dict[str, int]] = {}
    for class_name, deficit in deficits.items():
        base, remainder = divmod(deficit, 6)
        plan[class_name] = {}
        for i, transform in enumerate(TRANSFORMATIONS):
            n = base + (1 if i < remainder else 0)
            if n > 0:
                plan[class_name][transform] = n
    return plan
