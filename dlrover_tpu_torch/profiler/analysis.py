"""Stack analysis over hang dumps: the port's own copy of the stack part of
dlrover_tpu/profiler/analysis.py (``parse_faulthandler``, ``is_idle_stack``,
``StackTrie``, ``load_stacks``).

Where is everyone stuck? Merge every rank's Python stacks (faulthandler
dumps from ``profiler.hang_dump``) into a trie; a hang shows up as one deep
shared path, and its leaf is the frame the fleet is parked in. The JAX
module's timeline analysis, matmul bench and CLI wait for ROADMAP item 13.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# Stack trie (reference stack_viewer.py)
# ---------------------------------------------------------------------------

#: one faulthandler frame: `  File "x.py", line 10 in foo`
_FRAME_RE = re.compile(r'^\s*File "(?P<file>[^"]+)", line (?P<line>\d+) in (?P<func>.+)$')
_THREAD_RE = re.compile(r"^(Current thread|Thread) (?P<tid>0x[0-9a-fA-F]+)")


def parse_faulthandler(text: str, main_only: bool = False) -> List[List[str]]:
    """Parse faulthandler output into stacks, one per thread, each a list
    of ``func (file:line)`` frames ordered root-first (faulthandler prints
    most-recent-call-first; we reverse so the trie roots at the entry
    point, like a flamegraph).

    ``main_only`` keeps just the "Current thread" section — in a hang
    dump the main thread is the one parked in the collective, while each
    worker process carries several identical idle helper threads that
    would otherwise outweigh it in the trie.
    """
    stacks: List[List[str]] = []
    cur: Optional[List[str]] = None
    cur_is_main = False
    any_main = False

    def flush():
        if cur and (cur_is_main or not main_only):
            stacks.append(list(reversed(cur)))

    for line in text.splitlines():
        m_thread = _THREAD_RE.match(line)
        if m_thread:
            flush()
            cur = []
            cur_is_main = line.startswith("Current thread")
            any_main = any_main or cur_is_main
            continue
        m = _FRAME_RE.match(line)
        if m and cur is not None:
            short = os.path.basename(m.group("file"))
            cur.append(f"{m.group('func')} ({short}:{m.group('line')})")
    flush()
    if main_only and not any_main:
        # Dump without a "Current thread" marker: fall back to every
        # non-idle stack rather than returning nothing.
        return [s for s in parse_faulthandler(text) if not is_idle_stack(s)]
    return stacks


#: leaf frames of threads that are parked, not working: thread-pool
#: workers waiting on their queue, threading waits, selector polls.
#: Leaf-only on purpose — an executor thread actively running a task has
#: deeper frames (``_worker -> run -> fn``) and must stay visible; a
#: parked one is blocked in the C-level queue get, so its deepest
#: *Python* frame is ``_worker`` itself.
_IDLE_LEAF_RE = re.compile(
    r"^(wait|_wait_for_tstate_lock|_recv_bytes|poll|select|accept|"
    r"get|_get_block) \((threading|queue|selectors|socket|connection)\.py:"
    r"|^_worker \(thread\.py:"
    r"|^worker \(pool\.py:"
)


def is_idle_stack(frames: List[str]) -> bool:
    """True if a root-first stack belongs to a parked helper thread
    (thread-pool worker waiting for work, selector loop, queue get) —
    the stacks that drown out the busy thread when every thread is
    sampled with equal weight."""
    if not frames:
        return True
    return bool(_IDLE_LEAF_RE.match(frames[-1]))


@dataclass
class _TrieNode:
    weight: int = 0
    children: Dict[str, "_TrieNode"] = field(default_factory=dict)


class StackTrie:
    """Merge many ranks' stacks; shared prefixes accumulate weight so the
    dominant (stuck) path is the heaviest branch."""

    def __init__(self):
        self._root = _TrieNode()
        self.total = 0

    def insert(self, frames: List[str], weight: int = 1):
        self.total += weight
        node = self._root
        node.weight += weight
        for fr in frames:
            node = node.children.setdefault(fr, _TrieNode())
            node.weight += weight

    def add_dump(self, text: str, weight: int = 1, main_only: bool = False):
        for stack in parse_faulthandler(text, main_only=main_only):
            self.insert(stack, weight)

    def render(self, min_share: float = 0.05, _node=None, _depth=0) -> str:
        """Indented trie, heaviest children first, pruned below
        ``min_share`` of the total weight."""
        node = _node or self._root
        lines: List[str] = []
        if _depth == 0 and self.total == 0:
            return "<no stacks>"
        for name, child in sorted(
            node.children.items(), key=lambda kv: -kv[1].weight
        ):
            if child.weight < min_share * self.total:
                continue
            pct = 100.0 * child.weight / self.total
            lines.append(f"{'  ' * _depth}{child.weight:4d} {pct:5.1f}%  {name}")
            sub = self.render(min_share, child, _depth + 1)
            if sub:
                lines.append(sub)
        return "\n".join(l for l in lines if l)

    def hot_path(self) -> List[str]:
        """The single heaviest root-to-leaf path — for a collective hang
        this is the frame every rank is parked in."""
        path: List[str] = []
        node = self._root
        while node.children:
            name, node = max(node.children.items(), key=lambda kv: kv[1].weight)
            path.append(name)
        return path


def load_stacks(path: str) -> StackTrie:
    """Build a trie from a hang bundle JSON (``HangDumper.dump`` output:
    ``{"stacks": {pid: text}}``) or a directory of ``hang_stacks-*.txt``."""
    trie = StackTrie()
    if os.path.isdir(path):
        for fn in sorted(os.listdir(path)):
            if fn.startswith("hang_stacks-"):
                with open(os.path.join(path, fn)) as f:
                    trie.add_dump(f.read(), main_only=True)
    else:
        with open(path) as f:
            bundle = json.load(f)
        for text in bundle.get("stacks", {}).values():
            trie.add_dump(text, main_only=True)
    return trie
