"""GRPO rewards and the judge client (port of video_r2_tpu/rewards).

Every module here is a jax-free copy of its original; the exports are the
JAX package's.
"""

from .accuracy import accuracy_reward
from .format import format_reward
from .judge import EngineJudge, JudgeClient, OpenAICompatClient, chat_many
from .parsing import (
    extract_answer,
    extract_reasoning,
    infer_question_type,
    normalize_mcq,
    normalize_number,
    parse_decision,
    wer,
)
from .registry import load_reward_funcs
from .temporal import (
    calculate_grounding_reward,
    extract_grounding_claims,
    sanitize_timestamps_dict,
    temporal_grounding_sentence_embedding_consistency_reward,
)

__all__ = [
    "EngineJudge",
    "chat_many",
    "accuracy_reward", "format_reward",
    "JudgeClient", "OpenAICompatClient",
    "extract_answer", "extract_reasoning", "infer_question_type",
    "normalize_mcq", "normalize_number", "parse_decision", "wer",
    "load_reward_funcs",
    "calculate_grounding_reward", "extract_grounding_claims",
    "sanitize_timestamps_dict",
    "temporal_grounding_sentence_embedding_consistency_reward",
]
