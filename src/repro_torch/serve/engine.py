"""Continuous-batching serving engine (port of ``repro/serve/engine.py``).

A fixed pool of B cache *slots*; requests are admitted into free slots as
they arrive, every engine iteration runs ONE batched decode step across
all active slots (per-slot positions), and finished slots are freed
immediately for the next waiting request.  Prefill runs per request
(batch=1) and its cache rows are spliced into the slot pool.

The control logic is the reference's, token for token: admission order,
the splice, the ``max_seq`` cap, EOS, and the oversize-reject and
zero-token rules.  What differs is where the host waits for the device:
once per admission (the prefill's argmax) and once per decode step (all
slots' next tokens in one ``.tolist()``); slot positions are mirrored
on the host so the cap check reads no device memory.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.models.base import ModelConfig


# cache leaf -> batch axis (the reference's tables: the transformer, SSM
# and enc-dec layouts, and the hybrid's, whose SSM states and conv tails
# are stacked (G, attn_every, B, ...))
_BATCH_AXIS = {"k": 1, "v": 1, "xk": 1, "xv": 1, "ssm": 1, "conv": 1,
               "ssm_tail": 1, "conv_tail": 1}
_HYBRID_AXIS = {"k": 1, "v": 1, "ssm": 2, "conv": 2, "ssm_tail": 1,
                "conv_tail": 1}


def _axis_for(cfg: ModelConfig, key: str) -> int:
    return (_HYBRID_AXIS if cfg.family == "hybrid" else _BATCH_AXIS)[key]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int
    max_new_tokens: int = 16
    # filled by the engine:
    output: typing.List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False          # prompt too long for the cache


class Engine:
    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_seq: int = 512, eos_token: int = -1,
                 device="cuda") -> None:
        if cfg.family in api.STUB_KEYS:
            # the reference's engine admits these and fails at the first
            # prefill (a KeyError on the batch); the port refuses up front
            raise ValueError(
                f"{cfg.name}: the Engine hands prefill only a prompt's "
                f"tokens, and the {cfg.family} family's prefill also takes "
                f"{api.STUB_KEYS[cfg.family]!r}; serve it through "
                f"api.init_cache, api.prefill and api.decode_step")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos_token
        self.device = resolve_device(device)
        cache = api.init_cache(cfg, slots, max_seq, device=self.device)
        # engine-managed per-slot positions, mirrored on the host
        cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        self.cache = cache
        self._pos = [0] * slots
        self.active: typing.Dict[int, Request] = {}      # slot -> request
        self.remaining: typing.Dict[int, int] = {}
        self.last_token = torch.zeros((slots,), dtype=torch.long,
                                      device=self.device)
        self.queue: typing.List[Request] = []
        self._finished_early: typing.List[Request] = []
        self.steps = 0
        self.prefills = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request.  Returns False (request marked done+rejected,
        never queued) when the prompt cannot fit the cache."""
        if len(req.prompt) >= self.max_seq:
            req.rejected = True
            req.done = True
            return False
        self.queue.append(req)
        return True

    def _free_slots(self) -> typing.List[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def _admit(self) -> None:
        free = self._free_slots()
        while free and self.queue:
            req = self.queue.pop(0)
            if req.max_new_tokens <= 0:
                # nothing to generate: complete without touching a slot
                req.done = True
                self._finished_early.append(req)
                continue
            slot = free[0]
            prompt = torch.as_tensor(np.asarray(req.prompt),
                                     dtype=torch.long,
                                     device=self.device)[None]   # (1,S)
            S = int(prompt.shape[1])
            # A mini cache of the prompt's own length: the reference
            # splices max_seq rows, but rows past S are never read before
            # a decode step writes them (the mask stops at pos).  An SSM
            # cache has no sequence axis, so its length does not matter.
            mini = api.init_cache(self.cfg, 1, S, device=self.device)
            logits, mini = api.prefill(self.params, self.cfg, mini,
                                       {"tokens": prompt})
            self.prefills += 1
            self._splice(mini, slot, S)
            tok = int(torch.argmax(logits[0]))
            req.output.append(tok)
            if tok == self.eos or req.max_new_tokens == 1:
                # complete at admission: the prefill token is the whole
                # answer, so the slot stays free for the next request
                req.done = True
                self._finished_early.append(req)
                continue
            free.pop(0)
            self.last_token[slot] = tok
            self.active[slot] = req
            self.remaining[slot] = req.max_new_tokens - 1

    def _splice(self, mini: dict, slot: int, prompt_len: int) -> None:
        """Write the batch=1 prefill cache into slot ``slot``: every leaf
        but ``pos``, along its batch axis.  A leaf with a sequence axis
        (k, v) fills its first ``prompt_len`` rows, as the mini cache has
        no more; an SSM state or conv tail overwrites the whole slot."""
        for key, small in mini.items():
            if key == "pos":
                continue
            axis = _axis_for(self.cfg, key)
            small = small.select(axis, 0)
            big = self.cache[key].select(axis, slot)
            big[tuple(slice(0, n) for n in small.shape)] = small
        self.cache["pos"][slot] = prompt_len
        self._pos[slot] = prompt_len

    def step(self) -> typing.List[Request]:
        """One engine iteration: admit -> batched decode -> retire.
        Returns requests completed this step."""
        self._admit()
        done, self._finished_early = self._finished_early, []
        if not self.active:
            return done
        logits, self.cache = api.decode_step(self.params, self.cfg,
                                             self.cache, self.last_token)
        self.steps += 1
        # only active slots advance; idle slots re-decode garbage rows but
        # their outputs are ignored and their pos is reset on admission
        self.last_token = torch.argmax(logits, dim=-1)
        next_tok = self.last_token.tolist()
        self._pos = [p + 1 for p in self._pos]
        for slot, req in list(self.active.items()):
            tok = next_tok[slot]
            req.output.append(tok)
            self.remaining[slot] -= 1
            hit_cap = self._pos[slot] >= self.max_seq - 1
            if tok == self.eos or self.remaining[slot] <= 0 or hit_cap:
                req.done = True
                done.append(req)
                del self.active[slot]
                del self.remaining[slot]
        return done

    def run_until_drained(self, max_steps: int = 10_000
                          ) -> typing.List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self.queue:
                break
        return out

    def stats(self) -> dict:
        return {"decode_steps": self.steps, "prefills": self.prefills,
                "active": len(self.active), "queued": len(self.queue)}
