"""Error classes the port raises (the port's own copy of the subset of
``delta_tpu.utils.errors`` it needs): the log's, and the expression
language's (parser, row evaluator, host evaluator)."""
from __future__ import annotations

from typing import Iterable

__all__ = [
    "DeltaError", "DeltaAnalysisError", "DeltaIllegalStateError", "DeltaParseError",
    "VersionNotFoundError",
    "versions_not_contiguous", "cannot_tokenize_predicate",
    "unexpected_end_of_expression", "trailing_tokens", "unexpected_keyword",
    "bad_column_path", "unexpected_token", "expected_type_name", "parse_expected",
    "column_not_found_in_row", "column_not_found_in_table", "unsupported_function",
    "cannot_compare_types", "cannot_apply_operator", "like_requires_strings",
]


class DeltaError(Exception):
    """Base of every error the port raises on purpose."""


class DeltaAnalysisError(DeltaError):
    pass


class DeltaIllegalStateError(DeltaError, RuntimeError):
    pass


class DeltaParseError(DeltaAnalysisError):
    pass


class VersionNotFoundError(DeltaAnalysisError):
    def __init__(self, version: int, earliest: int, latest: int):
        super().__init__(
            f"Cannot time travel Delta table to version {version}. "
            f"Available versions: [{earliest}, {latest}]."
        )
        self.version = version
        self.earliest = earliest
        self.latest = latest


def versions_not_contiguous(versions: Iterable[int]) -> DeltaIllegalStateError:
    return DeltaIllegalStateError(
        f"Versions ({list(versions)}) are not contiguous.")


# -- the expression language's errors (parser, row evaluator, host evaluator) --


def cannot_tokenize_predicate(fragment: str) -> DeltaParseError:
    return DeltaParseError(
        f"Cannot tokenize predicate at {fragment!r}. Check for unbalanced "
        "quotes or unsupported characters.")


def unexpected_end_of_expression(source: str) -> DeltaParseError:
    return DeltaParseError(
        f"Unexpected end of expression: {source!r}. The predicate ends "
        "mid-term — a operand or closing parenthesis is missing.")


def trailing_tokens(token, source: str) -> DeltaParseError:
    return DeltaParseError(
        f"Trailing tokens at {token} in {source!r}. Combine multiple "
        "conditions with AND/OR.")


def unexpected_keyword(text: str, source: str) -> DeltaParseError:
    return DeltaParseError(f"Unexpected keyword {text} in {source!r}.")


def bad_column_path(source: str) -> DeltaParseError:
    return DeltaParseError(
        f"Bad column path after '.' in {source!r}. Nested fields are "
        "addressed as parent.child (backquote names with special characters).")


def unexpected_token(token, source: str) -> DeltaParseError:
    return DeltaParseError(f"Unexpected token {token} in {source!r}.")


def expected_type_name(token) -> DeltaParseError:
    return DeltaParseError(
        f"Expected type name, got {token}. Use a Delta type like INT, "
        "BIGINT, DOUBLE, STRING, DATE, TIMESTAMP, or DECIMAL(p, s).")


def parse_expected(what, got, source: str) -> DeltaParseError:
    return DeltaParseError(f"Expected {what} at token {got} in {source!r}")


def column_not_found_in_row(column: str, available) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Column not found: {column} in {list(available)}")


def column_not_found_in_table(column: str, available) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Column {column!r} not found among {list(available)}.")


def unsupported_function(name: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(
        f"Unsupported function: {name}. See delta_tpu_torch.expr.ir.Func.FUNCS "
        "for the supported surface.")


def cannot_compare_types(left: str, right: str, sql: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Cannot compare {left} with {right} in {sql}")


def cannot_apply_operator(op: str, left: str, right: str, sql: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"Cannot apply {op!r} to {left} and {right} in {sql}")


def like_requires_strings(got: str, sql: str) -> DeltaAnalysisError:
    return DeltaAnalysisError(f"LIKE requires string operands, got {got} in {sql}")
