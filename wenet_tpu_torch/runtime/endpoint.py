"""CTC endpoint detection.  Counterpart of wenet_tpu/runtime/endpoint.py:
kaldi's three rules on the blank posterior of each decoded frame.
  rule1: 5000 ms of silence, even when nothing was decoded
  rule2: 1000 ms of trailing silence after something was decoded
  rule3: an utterance longer than 20000 ms"""

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CtcEndpointRule:
    must_decoded_sth: bool = True
    min_trailing_silence: int = 1000
    min_utterance_length: int = 0


@dataclass
class CtcEndpointConfig:
    blank: int = 0
    blank_scale: float = 1.0
    blank_threshold: float = 0.8
    rule1: CtcEndpointRule = field(
        default_factory=lambda: CtcEndpointRule(False, 5000, 0))
    rule2: CtcEndpointRule = field(
        default_factory=lambda: CtcEndpointRule(True, 1000, 0))
    rule3: CtcEndpointRule = field(
        default_factory=lambda: CtcEndpointRule(False, 0, 20000))


class CtcEndpoint:

    def __init__(self, config: CtcEndpointConfig = None,
                 frame_shift_in_ms: int = 40):
        self.config = config or CtcEndpointConfig()
        self.frame_shift_in_ms = frame_shift_in_ms
        self.reset()

    def reset(self):
        self.num_frames_decoded = 0
        self.num_frames_trailing_blank = 0

    @staticmethod
    def _rule_activated(rule: CtcEndpointRule, decoded_sth: bool,
                        trailing_silence: int,
                        utterance_length: int) -> bool:
        return ((decoded_sth or not rule.must_decoded_sth)
                and trailing_silence >= rule.min_trailing_silence
                and utterance_length >= rule.min_utterance_length)

    def is_endpoint(self, ctc_log_probs: np.ndarray,
                    decoded_something: bool) -> bool:
        """ctc_log_probs: (T, V) log-probs of the newly decoded frames."""
        return self.is_endpoint_blank(
            np.asarray(ctc_log_probs)[:, self.config.blank],
            decoded_something)

    def is_endpoint_blank(self, blank_log_probs: np.ndarray,
                          decoded_something: bool) -> bool:
        """`is_endpoint` on the blank column alone, (T,)."""
        cfg = self.config
        for p in np.exp(np.asarray(blank_log_probs)):
            self.num_frames_decoded += 1
            if p > cfg.blank_threshold * cfg.blank_scale:
                self.num_frames_trailing_blank += 1
            else:
                self.num_frames_trailing_blank = 0
        ms = self.frame_shift_in_ms
        trailing = self.num_frames_trailing_blank * ms
        utterance = self.num_frames_decoded * ms
        return any(self._rule_activated(rule, decoded_something, trailing,
                                        utterance)
                   for rule in (cfg.rule1, cfg.rule2, cfg.rule3))
