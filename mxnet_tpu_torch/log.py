"""Logging utilities (the counterpart of `mxnet_tpu/log.py`; reference
``python/mxnet/log.py``).

Provides the colored single-letter-level formatter and ``get_logger``;
``getLogger`` is the deprecated alias the reference keeps.
"""
import logging
import sys
import warnings

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_LEVEL_CHAR = {logging.CRITICAL: 'C', logging.ERROR: 'E',
               logging.WARNING: 'W', logging.INFO: 'I',
               logging.DEBUG: 'D'}


class _Formatter(logging.Formatter):
    """``L MMDD HH:MM:SS message`` formatter: warnings+ red, info
    green, debug blue — matching the reference's terminal format.
    ``colored=False`` emits plain text (file handlers, non-TTY
    streams: ANSI escapes in CI logs and log files are garbage)."""

    def __init__(self, colored=True):
        super().__init__(datefmt='%m%d %H:%M:%S')
        self.colored = bool(colored)

    def _color(self, level):
        if level >= logging.WARNING:
            return '\x1b[31m'
        if level >= logging.INFO:
            return '\x1b[32m'
        return '\x1b[34m'

    def format(self, record):
        head = (_LEVEL_CHAR.get(record.levelno, 'U')
                + ' %(asctime)s %(process)d %(pathname)s:%(funcName)s:'
                  '%(lineno)d')
        if self.colored:
            fmt = self._color(record.levelno) + head + '\x1b[0m %(message)s'
        else:
            fmt = head + ' %(message)s'
        self._style._fmt = fmt
        return super().format(record)


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias for :func:`get_logger`."""
    warnings.warn("getLogger is deprecated, Use get_logger instead.",
                  DeprecationWarning)
    return get_logger(name, filename, filemode, level)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Return a logger with the mxnet formatter attached (once).

    With ``filename`` logs go to the file (mode ``filemode`` or 'a'),
    otherwise to stderr with colors.
    """
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, '_init_done', False):
        logger._init_done = True
        if filename:
            hdlr = logging.FileHandler(filename, filemode or 'a')
            colored = False  # never ANSI-pollute a log file
        else:
            hdlr = logging.StreamHandler(sys.stderr)
            colored = bool(getattr(sys.stderr, 'isatty', lambda: False)())
        hdlr.setFormatter(_Formatter(colored=colored))
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger
