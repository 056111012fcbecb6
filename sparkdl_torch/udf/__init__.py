from sparkdl_torch.udf.keras_image_model import registerKerasImageUDF
from sparkdl_torch.udf.registry import applyUDF, getUDF, listUDFs, registerUDF

__all__ = ["applyUDF", "registerKerasImageUDF", "registerUDF", "getUDF", "listUDFs"]
