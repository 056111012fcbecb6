from sparkdl_torch.estimators.keras_image_file_estimator import KerasImageFileEstimator

__all__ = ["KerasImageFileEstimator"]
