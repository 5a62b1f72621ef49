"""Notebook training callbacks (the counterpart of
`mxnet_tpu/notebook/callback.py`; reference
``python/mxnet/notebook/callback.py``).

``PandasLogger`` records train/eval/epoch metric frames from
``model.fit``/``Module.fit`` callback params; the live charts render a
learning curve as training progresses.  The reference draws with bokeh;
here the renderer is matplotlib and chart
classes degrade to data-capture-only when no display backend is usable —
the captured data contract is identical either way.
"""
import datetime
import time

try:
    import pandas as pd
except ImportError:  # a host without pandas: PandasLogger raises on use
    pd = None


def _require_pandas():
    if pd is None:
        raise ImportError("PandasLogger requires pandas")


def _add_new_columns(dataframe, metrics):
    """Add columns for new metrics not yet seen in the dataframe."""
    new_cols = set(metrics.keys()) - set(dataframe.columns)
    for col in new_cols:
        dataframe[col] = None


class PandasLogger(object):
    """Log training statistics into three pandas DataFrames
    (``train``/``eval``/``epoch``), one row per callback firing.

    Parameters
    ----------
    batch_size : int
        Batch size, used to turn batch rate into records/sec.
    frequent : int
        Mini-batches between training-metric rows (eval rows land once
        per epoch over the whole eval set).
    """

    def __init__(self, batch_size, frequent=50):
        _require_pandas()
        self.batch_size = batch_size
        self.frequent = frequent
        self._dataframes = {'train': pd.DataFrame(), 'eval': pd.DataFrame(),
                            'epoch': pd.DataFrame()}
        self.last_time = time.time()
        self.start_time = datetime.datetime.now()
        self.last_epoch_time = datetime.datetime.now()

    @property
    def train_df(self):
        """Metrics for training minibatches, every ``frequent`` batches."""
        return self._dataframes['train']

    @property
    def eval_df(self):
        """Metrics for the eval set, once per epoch."""
        return self._dataframes['eval']

    @property
    def epoch_df(self):
        """Per-epoch wall-clock rows."""
        return self._dataframes['epoch']

    @property
    def all_dataframes(self):
        """Dict of all three dataframes."""
        return self._dataframes

    def elapsed(self):
        """Wall time since this logger was created."""
        return datetime.datetime.now() - self.start_time

    def append_metrics(self, metrics, df_name):
        """Append one row of ``metrics`` to the named dataframe."""
        dataframe = self._dataframes[df_name]
        _add_new_columns(dataframe, metrics)
        self._dataframes[df_name] = pd.concat(
            [dataframe, pd.DataFrame([metrics])], ignore_index=True)

    def train_cb(self, param):
        """batch_end_callback: record a train row every ``frequent``."""
        if param.nbatch % self.frequent == 0:
            self._process_batch(param, 'train')

    def eval_cb(self, param):
        """eval_end_callback: record an eval row."""
        self._process_batch(param, 'eval')

    def _process_batch(self, param, dataframe):
        now = time.time()
        if param.eval_metric is not None:
            metrics = dict(param.eval_metric.get_name_value())
            param.eval_metric.reset()
        else:
            metrics = {}
        try:
            speed = self.frequent / (now - self.last_time)
        except ZeroDivisionError:
            speed = float('inf')
        # (the reference assigns these two swapped — a bug its notebooks
        # inherited; speed IS batches/sec, records scale by batch_size)
        metrics['batches_per_sec'] = speed
        metrics['records_per_sec'] = speed * self.batch_size
        metrics['elapsed'] = self.elapsed()
        metrics['minibatch_count'] = param.nbatch
        metrics['epoch'] = param.epoch
        self.append_metrics(metrics, dataframe)
        self.last_time = now

    def epoch_cb(self, *args):
        """epoch_end_callback: record epoch wall time.  Accepts and ignores
        the ``(epoch, symbol, arg_params, aux_params)`` callback signature
        (the reference's zero-arg ``epoch_cb`` crashes under ``fit``)."""
        now = datetime.datetime.now()
        self.append_metrics({'elapsed': self.elapsed(),
                             'epoch_time': now - self.last_epoch_time},
                            'epoch')
        self.last_epoch_time = now

    def callback_args(self):
        """kwargs for ``model.fit`` enabling all three callbacks:
        ``model.fit(X=train, eval_data=test, **logger.callback_args())``."""
        return {'batch_end_callback': self.train_cb,
                'eval_end_callback': self.eval_cb,
                'epoch_end_callback': self.epoch_cb}


def _matplotlib_display():
    """Return (pyplot, display_fn) if a notebook/Agg renderer is usable,
    else (None, None) — charts then capture data without drawing."""
    try:
        import matplotlib
        matplotlib.use('Agg', force=False)
        import matplotlib.pyplot as plt
        return plt, getattr(plt, 'draw', None)
    except Exception:
        return None, None


class LiveChart(object):
    """Base live chart: throttled re-render as metric values stream in
    (the reference's ``LiveBokehChart`` role, matplotlib-rendered)."""

    def __init__(self, pandas_logger, metric_name, display_freq=10,
                 batch_size=None, frequent=50):
        self.pandas_logger = pandas_logger or PandasLogger(
            batch_size=batch_size or 1, frequent=frequent)
        self.display_freq = display_freq
        self.last_update = time.time()
        self.metric_name = metric_name
        self._plt, _ = _matplotlib_display()
        self.fig = None
        self.setup_chart()

    def setup_chart(self):
        if self._plt is not None:
            self.fig = self._plt.figure()

    def interval_elapsed(self):
        return time.time() - self.last_update > self.display_freq

    def _do_update(self):
        self.update_chart_data()
        self.last_update = time.time()

    def update_chart_data(self):
        raise NotImplementedError()

    def batch_cb(self, param):
        """batch_end_callback: re-render if the interval elapsed."""
        self.pandas_logger.train_cb(param)
        if self.interval_elapsed():
            self._do_update()

    def eval_cb(self, param):
        """eval_end_callback: always re-render after an eval pass."""
        self.pandas_logger.eval_cb(param)
        self._do_update()

    def callback_args(self):
        """kwargs for ``model.fit`` wiring this chart's callbacks."""
        return {'batch_end_callback': self.batch_cb,
                'eval_end_callback': self.eval_cb}


# bokeh-era alias kept for scripts written against the reference name
LiveBokehChart = LiveChart


class LiveTimeSeries(LiveChart):
    """Live plot of a single value stream against elapsed time."""

    def __init__(self, **fig_params):
        self.x_axis_val = []
        self.y_axis_val = []
        super().__init__(None, None, **fig_params)
        self.start_time = datetime.datetime.now()

    def elapsed(self):
        return datetime.datetime.now() - self.start_time

    def update_chart_data(self, value=None):
        if value is not None:
            self.x_axis_val.append(self.elapsed().total_seconds())
            self.y_axis_val.append(value)
        if self.fig is not None:
            ax = self.fig.gca()
            ax.clear()
            ax.plot(self.x_axis_val, self.y_axis_val)
            ax.set_xlabel('Elapsed time (s)')


class LiveLearningCurve(LiveChart):
    """Live train/validation learning curve for one metric."""

    def __init__(self, metric_name, display_freq=10, frequent=50):
        self._data = {'train': {'elapsed': [], metric_name: []},
                      'eval': {'elapsed': [], metric_name: []}}
        super().__init__(None, metric_name, display_freq,
                         frequent=frequent)

    def _capture(self, param, phase):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if name == self.metric_name:
                self._data[phase]['elapsed'].append(
                    (datetime.datetime.now()
                     - self.pandas_logger.start_time).total_seconds())
                self._data[phase][self.metric_name].append(value)

    def batch_cb(self, param):
        self._capture(param, 'train')
        super().batch_cb(param)

    def eval_cb(self, param):
        self._capture(param, 'eval')
        super().eval_cb(param)

    def update_chart_data(self):
        if self.fig is None:
            return
        ax = self.fig.gca()
        ax.clear()
        for phase, style in (('train', ':'), ('eval', '-')):
            d = self._data[phase]
            if d[self.metric_name]:
                ax.plot(d['elapsed'], d[self.metric_name], style,
                        label=phase)
        ax.set_xlabel('Training time (s)')
        ax.set_ylabel(self.metric_name)
        ax.legend()
