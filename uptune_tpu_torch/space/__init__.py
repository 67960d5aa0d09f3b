"""Search-space layer: parameter specs + flat encoding."""
from .params import (  # noqa: F401
    FLOAT, INT, LOG_FLOAT, LOG_INT, POW2, BOOL, SWITCH, ENUM,
    ParamSpec, FloatParam, IntParam, LogFloatParam, LogIntParam, Pow2Param,
    BoolParam, SwitchParam, EnumParam, PermParam, ScheduleParam,
    SelectorParam, ArrayParam, BoolArrayParam, IntArrayParam,
    FloatArrayParam, infer_param,
)
from .spec import CandBatch, Space, concat_cands, pad_cands  # noqa: F401
