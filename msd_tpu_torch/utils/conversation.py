"""Prompt templates (LLaVA conversation formats).

The port's copy of the JAX package's ``utils/conversation.py`` (reference:
LLaVA/llava/conversation.py:19-396). Only the vicuna_v1 template the MSD
pipeline exercises; the MSD adapter BLANKS the system prompt
(conv.system = "", llava_msd_calibrated.py:558), which this reproduces to
match reference outputs token for token.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEFAULT_VICUNA_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions.")


@dataclass
class Conversation:
    """Two-role conversation with separator-style prompting (vicuna_v1)."""

    system: str = DEFAULT_VICUNA_SYSTEM
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    sep: str = " "
    sep2: str = "</s>"
    messages: List[Tuple[str, Optional[str]]] = field(default_factory=list)

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        seps = [self.sep, self.sep2]
        out = self.system + self.sep if self.system else ""
        for i, (role, msg) in enumerate(self.messages):
            if msg is not None:
                out += f"{role}: {msg}{seps[i % 2]}"
            else:
                out += f"{role}:"
        return out

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            sep=self.sep, sep2=self.sep2,
                            messages=list(self.messages))


def vicuna_v1(system: str = "") -> Conversation:
    """MSD-adapter default: vicuna_v1 with blanked system prompt."""
    return Conversation(system=system)


def build_msd_prompt(question: str, with_image: bool = True,
                     system: str = "") -> str:
    """Exact prompt shape used by llava_msd_calibrated.py:537-560."""
    conv = vicuna_v1(system)
    q = f"<image>\n{question}" if with_image else question
    conv.append_message(conv.roles[0], q)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()
