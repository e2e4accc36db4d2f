"""``X-Keto-Tenant`` on the port's REST routes (the CPU): the port serves the
default tenant alone (multi-tenant serving is ROADMAP A9). No header, a
blank one or ``default`` serve as always; a malformed id answers the
reference's 400, body for body; any other tenant answers 400 naming A9. On
``GET /check``, ``POST /check/batch``, ``PUT`` and ``PATCH
/relation-tuples``, ``GET /relation-tuples`` and ``GET /watch``: a request
addressed to another tenant is never answered from, or written into, the
default tenant's store."""

from __future__ import annotations

import pytest
from test_torch_rest import _req

from keto_tpu_torch import namespace as tns
from keto_tpu_torch.driver.daemon import Daemon
from keto_tpu_torch.relationtuple.model import RelationQuery, RelationTuple

GRANT = RelationTuple.from_string("acl:obj-1#access@user-1")
NEW = {"namespace": "acl", "object": "obj-2", "relation": "access", "subject_id": "user-2"}

ROUTES = {
    "GET /check": ("read", "GET", "/check?" + GRANT.to_url_query(), None),
    "POST /check/batch": ("read", "POST", "/check/batch", {"tuples": [GRANT.to_json()]}),
    "GET /relation-tuples": ("read", "GET", "/relation-tuples?namespace=acl", None),
    "GET /watch": ("read", "GET", "/watch?snaptoken=1", None),
    "PUT /relation-tuples": ("write", "PUT", "/relation-tuples", NEW),
    "PATCH /relation-tuples": ("write", "PATCH", "/relation-tuples",
                               [{"action": "insert", "relation_tuple": NEW}]),
    "DELETE /relation-tuples": ("write", "DELETE", "/relation-tuples?" + GRANT.to_url_query(),
                                None),
}


@pytest.fixture(scope="module")
def pair():
    """The port's daemon and the reference's, one grant each."""
    from keto_tpu.config.provider import Config
    from keto_tpu.driver.registry import Registry
    from keto_tpu.relationtuple.model import RelationTuple as RT
    from keto_tpu.servers.rest import READ, WRITE, RestServer

    mine = Daemon([tns.Namespace(id=0, name="acl")], device="cpu", tuples=[GRANT])
    mine.start()
    reg = Registry(Config(overrides={"namespaces": [{"id": 0, "name": "acl"}]}, env={}))
    reg.relation_tuple_manager().write_relation_tuples(RT.from_string(str(GRANT)))
    ref = {"read": RestServer(reg, READ, port=0), "write": RestServer(reg, WRITE, port=0)}
    for s in ref.values():
        s.start()
    yield mine, ref
    for s in ref.values():
        s.stop()
    reg.close()
    mine.stop()


def _hreq(method, port, path, body, tenant):
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    headers = {} if tenant is None else {"X-Keto-Tenant": tenant}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            # a watch stream would never end: its status is the answer
            return r.status, None if path.startswith("/watch") else r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _default_store(daemon):
    store = daemon.store
    return store.watermark(), sorted(str(t) for t in store.get_relation_tuples(RelationQuery())[0])


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("tenant", ["acme", "bad id!", "-lead", "x" * 65])
def test_another_or_malformed_tenant_is_refused(pair, route, tenant):
    mine, ref = pair
    role, method, path, body = ROUTES[route]
    before = _default_store(mine)
    status, got = _hreq(method, getattr(mine, role).port, path, body, tenant)
    assert status == 400
    if tenant == "acme":
        assert "ROADMAP A9" in got["error"]["message"] and "'acme'" in got["error"]["message"]
    else:
        want_status, want = _hreq(method, ref[role].port, path, body, tenant)
        assert (status, got) == (want_status, want)
    assert _default_store(mine) == before, \
        "a request addressed to another tenant touched the default store"


@pytest.mark.parametrize("tenant", [None, "", "  ", "default"])
def test_the_default_tenant_serves_as_always(pair, tenant):
    mine, _ = pair
    status, _ = _hreq("GET", mine.read.port, "/check?" + GRANT.to_url_query(), None, tenant)
    assert status == 200
    status, _ = _hreq("GET", mine.read.port, "/check?namespace=acl&object=obj-1&relation=access"
                      "&subject_id=nobody", None, tenant)
    assert status == 403
    assert _hreq("GET", mine.read.port, "/watch?snaptoken=0", None, tenant)[0] == 200


def test_the_reference_answers_another_tenant_from_its_own_store(pair):
    """Why the refusal: the reference answers ``acme`` from acme's own
    (empty) store, never the default one's."""
    _, ref = pair
    status, _ = _hreq("GET", ref["read"].port, "/check?" + GRANT.to_url_query(), None, "acme")
    assert status == 403
    assert _req("GET", ref["read"].port, "/check?" + GRANT.to_url_query())[0] == 200
