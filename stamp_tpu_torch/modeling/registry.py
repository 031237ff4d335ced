"""Model registry: (feature_type, task) × model_name → task wrapper + module.

Counterpart of ``stamp_tpu/modeling/registry.py``: ``ModelName`` is copied
value for value (the config schema validates against it); ``load_model_class``
returns the port's classes, which so far cover the tile-level ViT.  Every
other combination raises ``NotImplementedError`` naming the JAX package's
command.
"""

from enum import StrEnum

from stamp_tpu_torch.types import Task


class ModelName(StrEnum):
    """Enum for available model names."""

    VIT = "vit"
    MLP = "mlp"
    TRANS_MIL = "trans_mil"
    LINEAR = "linear"
    BARSPOON = "barspoon"


def load_model_class(task: Task, feature_type: str, model_name: ModelName, *, command: str = "deploy"):
    """Returns (TaskModelClass, ModuleClass); imports deferred.  ``command``
    is the JAX package's command the error names for what is not ported."""
    from stamp_tpu_torch.modeling import tasks

    if feature_type != "tile" or model_name != ModelName.VIT:
        raise NotImplementedError(
            f"the {model_name.value!s} backbone on {feature_type}-level features is not "
            f"ported yet; run `python -m stamp_tpu {command}`"
        )
    from stamp_tpu_torch.models.vision_transformer import VisionTransformer

    registry = {
        "classification": tasks.LitTileClassifier,
        "regression": tasks.LitTileRegressor,
        "survival": tasks.LitTileSurvival,
    }
    return registry[task], VisionTransformer
