"""Inference-chain engine: problems -> observations -> resolutions. The
port's own copy of dlrover_tpu/diagnosis/inference.py.

An ``Inference`` is a
(name, attribution, description) fact; operators either *observe* (turn a
"is X happening?" problem into confirmed facts) or *resolve* (turn a
confirmed fact into follow-up facts / actions). The chain walks compatible
operators breadth-first until no operator advances the frontier.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Sequence


class InferenceName:
    TRAINING = "training"
    NODE = "node"
    ACTION = "action"


class InferenceAttribute:
    ISORNOT = "is_or_not"
    IS = "is"
    NOT = "not"
    COLLECT = "collect"


class InferenceDescription:
    HANG = "hang"
    FAILURE = "failure"
    RESOURCE = "resource"


@dataclass(frozen=True)
class Inference:
    name: str = ""
    attribution: str = ""
    description: str = ""
    configuration: tuple = field(default_factory=tuple)  # ((k, v), ...)

    def config(self) -> Dict[str, str]:
        return dict(self.configuration)

    def with_config(self, **kw) -> "Inference":
        merged = dict(self.configuration)
        merged.update({k: str(v) for k, v in kw.items()})
        return Inference(
            self.name, self.attribution, self.description, tuple(sorted(merged.items()))
        )


class InferenceOperator(ABC):
    """One reasoning step. ``data_manager`` gives access to observations."""

    def __init__(self, data_manager=None):
        self._data_manager = data_manager

    @abstractmethod
    def is_compatible(self, inference: Inference) -> bool:
        ...

    @abstractmethod
    def infer(self, inferences: List[Inference]) -> List[Inference]:
        ...


class InferenceChain:
    """Walk operators over a frontier of problems until quiescent."""

    def __init__(self, inferences: Sequence[Inference], operators: Sequence[InferenceOperator]):
        self._frontier = list(inferences)
        self._operators = list(operators)

    def infer(self, max_depth: int = 8) -> List[Inference]:
        frontier = list(self._frontier)
        seen = set(frontier)
        results: List[Inference] = []
        depth = 0
        while frontier and depth < max_depth:
            depth += 1
            next_frontier: List[Inference] = []
            for problem in frontier:
                advanced = False
                for op in self._operators:
                    if not op.is_compatible(problem):
                        continue
                    for fact in op.infer([problem]):
                        advanced = True
                        if fact not in seen:
                            seen.add(fact)
                            next_frontier.append(fact)
                if not advanced:
                    results.append(problem)
            frontier = next_frontier
        results.extend(frontier)  # depth-capped leftovers
        out: List[Inference] = []
        for fact in results:
            if fact not in out:
                out.append(fact)
        return out
