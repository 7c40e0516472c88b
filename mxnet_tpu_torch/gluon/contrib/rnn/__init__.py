"""``gluon.contrib.rnn`` of the port: ``VariationalDropoutCell``. The
convolutional cells (``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``, reference
``conv_rnn_cell.py``) need the 1-D/3-D and dilated convolutions of
ROADMAP.md's port queue 1, item 4: constructing one raises
:class:`MXNetError` naming that item."""
from ....base import MXNetError
from ...rnn.rnn_cell import RecurrentCell
from .rnn_cell import VariationalDropoutCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell"]


def _refusing(name):
    def __init__(self, *args, **kwargs):
        raise MXNetError(f"{name} is not ported yet: it needs the 1-D/3-D "
                         "and dilated convolutions (ROADMAP.md, port queue "
                         "1, item 4)")

    return type(name, (RecurrentCell,), {
        "__init__": __init__,
        "__doc__": f"``{name}``: not ported yet (ROADMAP.md, port queue 1, "
                   "item 4)."})


Conv1DRNNCell = _refusing("Conv1DRNNCell")
Conv2DRNNCell = _refusing("Conv2DRNNCell")
Conv3DRNNCell = _refusing("Conv3DRNNCell")
Conv1DLSTMCell = _refusing("Conv1DLSTMCell")
Conv2DLSTMCell = _refusing("Conv2DLSTMCell")
Conv3DLSTMCell = _refusing("Conv3DLSTMCell")
Conv1DGRUCell = _refusing("Conv1DGRUCell")
Conv2DGRUCell = _refusing("Conv2DGRUCell")
Conv3DGRUCell = _refusing("Conv3DGRUCell")
