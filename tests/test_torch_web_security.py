"""The JAX app's security regression tests
(``tests/test_security_regression.py``) against the port's app.

Every test of that module is imported here and runs unchanged: its
fixtures (``app``, ``client``, ``licensed_app``) build the app through the
module global ``test_security_regression.create_app``, which the autouse
fixture below points at the port's ``create_app(..., device="cpu")`` for
the length of each test.  ``test_production_refuses_sms_test_code``
imports the JAX app's ``StartupError`` in its body and is left out; its
counterpart below expects the port's.
"""

import tempfile

import pytest

import test_security_regression
from test_security_regression import *  # noqa: F401,F403

from deepvision_tpu_torch.web.server import StartupError
from deepvision_tpu_torch.web.server import create_app as port_create_app

del pytestmark  # noqa: F821 — the smoke tier stays the JAX app's
# its body imports deepvision_tpu.web.server.StartupError
del test_production_refuses_sms_test_code  # noqa: F821

BUILT = []


def _port_create_app(*args, **kwargs):
    app = port_create_app(*args, device="cpu", **kwargs)
    BUILT.append(type(app.state).__module__)
    return app


@pytest.fixture(autouse=True)
def _port_app(monkeypatch):
    monkeypatch.setattr(test_security_regression, "create_app",
                        _port_create_app)
    BUILT.clear()
    yield
    assert set(BUILT) <= {"deepvision_tpu_torch.web.server"}, BUILT


def test_port_production_refuses_sms_test_code():
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(StartupError):
            port_create_app(data_dir=tmp, device="cpu", overrides={
                "DEBUG_MODE": False,
                "SECRET_KEY": "x" * 32,
                "SMS_PROVIDER": "jdcloud",
                "SMS_TEST_CODE": "666666",
            })
