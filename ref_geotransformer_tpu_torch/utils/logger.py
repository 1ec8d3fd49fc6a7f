"""Console + file logger, process-0 gated (ref parity: engine/logger.py:6-53).

A copy of `ref_geotransformer_tpu/utils/logger.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional


class Logger:
    def __init__(self, log_file: Optional[str] = None, local_rank: int = -1):
        self.logger = logging.getLogger("ref_geotransformer_tpu_torch")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        self.local_rank = local_rank
        if local_rank in (0, -1):
            if not self.logger.handlers:
                handler = logging.StreamHandler(sys.stdout)
                handler.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s"))
                self.logger.addHandler(handler)
            if log_file is not None:
                fh = logging.FileHandler(log_file)
                fh.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s"))
                self.logger.addHandler(fh)

    def _gated(self):
        return self.local_rank in (0, -1)

    def debug(self, message: str) -> None:
        if self._gated():
            self.logger.debug(message)

    def info(self, message: str) -> None:
        if self._gated():
            self.logger.info(message)

    def warning(self, message: str) -> None:
        if self._gated():
            self.logger.warning(message)

    def error(self, message: str) -> None:
        if self._gated():
            self.logger.error(message)

    def critical(self, message: str) -> None:
        if self._gated():
            self.logger.critical(message)
