"""Policy expression language (reference: mixer/pkg/expr + mixer/pkg/il)."""

from istio_tpu_torch.expr.exprs import Expression, Constant, Variable, FunctionCall
from istio_tpu_torch.expr.parser import parse, extract_eq_matches, ParseError
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder, FunctionMetadata,
                                    eval_type, func_map, TypeError_,
                                    DEFAULT_FUNCS)
from istio_tpu_torch.expr.oracle import (OracleProgram, OracleEvaluator, EvalError,
                                   evaluate)

__all__ = [
    "Expression", "Constant", "Variable", "FunctionCall",
    "parse", "extract_eq_matches", "ParseError",
    "AttributeDescriptorFinder", "FunctionMetadata", "eval_type", "func_map",
    "TypeError_", "DEFAULT_FUNCS",
    "OracleProgram", "OracleEvaluator", "EvalError", "evaluate",
]
