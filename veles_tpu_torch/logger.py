"""Class-scoped logging: the port's own copy of the ``Logger`` mixin of
:mod:`veles_tpu.logger` (the SQLite log mirror is not ported)."""

import logging


class Logger(object):
    """Mixin giving every object a logger named after its class."""

    def __init__(self, **kwargs):
        super(Logger, self).__init__()
        self._logger_ = logging.getLogger(self.__class__.__name__)

    @property
    def logger(self):
        return self._logger_

    def debug(self, msg, *args):
        self._logger_.debug(msg, *args)

    def info(self, msg, *args):
        self._logger_.info(msg, *args)

    def warning(self, msg, *args):
        self._logger_.warning(msg, *args)

    def error(self, msg, *args):
        self._logger_.error(msg, *args)

    def exception(self, msg="", *args):
        self._logger_.exception(msg, *args)
