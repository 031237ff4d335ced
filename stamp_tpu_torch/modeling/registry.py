"""Model registry: (feature_type, task) × model_name → task wrapper + module.

Counterpart of ``stamp_tpu/modeling/registry.py:21-56``: ``ModelName`` is
copied value for value (the config schema validates against it), and
``load_model_class`` returns the port's classes for the same table: the
tile, slide and patient wrappers for classification, regression and
survival, and ``barspoon`` always with ``LitEncDecTransformer``.  An
unknown name raises ``ValueError``.
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


def load_model_class(task: Task, feature_type: str, model_name: ModelName):
    """Returns (TaskModelClass, ModuleClass); imports deferred."""
    from stamp_tpu_torch.modeling import tasks

    registry = {
        ("tile", "classification"): tasks.LitTileClassifier,
        ("tile", "regression"): tasks.LitTileRegressor,
        ("tile", "survival"): tasks.LitTileSurvival,
        ("slide", "classification"): tasks.LitSlideClassifier,
        ("slide", "regression"): tasks.LitSlideRegressor,
        ("slide", "survival"): tasks.LitSlideSurvival,
        ("patient", "classification"): tasks.LitPatientClassifier,
        ("patient", "regression"): tasks.LitPatientRegressor,
        ("patient", "survival"): tasks.LitPatientSurvival,
    }
    lit_class = registry[(feature_type, task)]

    match model_name:
        case ModelName.VIT:
            from stamp_tpu_torch.models.vision_transformer import VisionTransformer as module_class
        case ModelName.TRANS_MIL:
            from stamp_tpu_torch.models.trans_mil import TransMIL as module_class
        case ModelName.MLP:
            from stamp_tpu_torch.models.mlp import MLP as module_class
        case ModelName.BARSPOON:
            from stamp_tpu_torch.models.barspoon import EncDecTransformer as module_class

            lit_class = tasks.LitEncDecTransformer
        case ModelName.LINEAR:
            from stamp_tpu_torch.models.mlp import Linear as module_class
        case _:
            raise ValueError(f"Unknown model name: {model_name}")

    return lit_class, module_class
