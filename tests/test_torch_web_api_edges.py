"""The JAX app's edge-case tests (``tests/test_api_edges.py``) against the
port's app.

Every test of that module is imported here and runs unchanged: its
fixtures (``client``, ``wx_client``) build the app through the module
global ``test_api_edges.create_app``, and its WeChat tests patch
``exchange_code`` on the module global ``test_api_edges.WeChatOAuth``.
The autouse fixture below points both at the port's (``create_app(...,
device="cpu")`` and the port's ``WeChatOAuth``, which the port's auth
routes use) for the length of each test, so none is left out.
"""

import pytest

import test_api_edges
from test_api_edges import *  # noqa: F401,F403

from deepvision_tpu_torch.web.server import create_app as port_create_app
from deepvision_tpu_torch.web.wechat import WeChatOAuth as PortWeChatOAuth

BUILT = []


def _port_create_app(*args, **kwargs):
    app = port_create_app(*args, device="cpu", **kwargs)
    BUILT.append(type(app.state).__module__)
    return app


@pytest.fixture(autouse=True)
def _port_app(monkeypatch):
    monkeypatch.setattr(test_api_edges, "create_app", _port_create_app)
    monkeypatch.setattr(test_api_edges, "WeChatOAuth", PortWeChatOAuth)
    BUILT.clear()
    yield
    assert set(BUILT) <= {"deepvision_tpu_torch.web.server"}, BUILT
