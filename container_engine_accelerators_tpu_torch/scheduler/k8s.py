# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Minimal Kubernetes REST client (requests-based).

The runtime image carries no kubernetes python package, so the scheduler and
labeler talk to the API server directly: in-cluster service-account auth
(token + CA from the serviceaccount mount), JSON over HTTPS. Only the verbs
the stack needs are implemented.

Copy of ``container_engine_accelerators_tpu/scheduler/k8s.py``: the
port's replica lifecycle (``fleet/lifecycle.py``) acts through it.
"""

import json
import logging
import os
import random
import time

import requests

log = logging.getLogger(__name__)

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Default retry budget for the unbind GET+PATCH loop (monotonic seconds).
UNBIND_DEADLINE_S = 5.0

# Ownership marker for controller-applied cordons (see cordon_node).
CORDONED_BY_ANNOTATION = "tpu-topology.gke.io/cordoned-by"


def backoff_sleep(attempt, base_s, cap_s, deadline=None, rng=None,
                  sleep=time.sleep, clock=time.monotonic):
    """One retry-loop sleep: exponential in ``attempt`` (0-based), capped
    at ``cap_s``, jittered to [0.5, 1.0]× nominal, and hard-bounded by
    the monotonic ``deadline``.

    The jitter exists for apiserver recovery: every retry loop in every
    daemon replica waking at the same fixed offsets after an outage is a
    thundering herd; randomizing within the same expected budget spreads
    it. The deadline is enforced BEFORE and INSIDE the sleep — a caller
    at its budget neither sleeps past it nor gets one more free retry.
    Returns False (without sleeping) when the deadline has passed, else
    sleeps and returns True."""
    delay = min(cap_s, base_s * (2 ** attempt))
    delay *= 0.5 + (rng or random).random() / 2
    if deadline is not None:
        remaining = deadline - clock()
        if remaining <= 0:
            return False
        delay = min(delay, remaining)
    sleep(delay)
    return True


class KubeError(RuntimeError):
    def __init__(self, status, body):
        super().__init__(f"k8s API error {status}: {body[:300]}")
        self.status = status
        self.body = body


class KubeClient:
    def __init__(self, base_url=None, token=None, ca_cert=None, session=None):
        if base_url is None:
            # KUBE_API_URL wins (tests / out-of-cluster); else in-cluster.
            base_url = os.environ.get("KUBE_API_URL")
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        if token is None:
            # KUBE_TOKEN wins (dev clusters / hermetic e2e against an
            # RBAC-enforcing local server); else the in-cluster
            # serviceaccount mount.
            token = os.environ.get("KUBE_TOKEN")
        if token is None:
            token_path = os.path.join(SERVICEACCOUNT_DIR, "token")
            if os.path.exists(token_path):
                with open(token_path) as f:
                    token = f.read().strip()
        self.token = token
        if ca_cert is None:
            ca_path = os.path.join(SERVICEACCOUNT_DIR, "ca.crt")
            # No in-cluster CA → fall back to system trust store (True), NOT
            # to disabling verification; pass ca_cert=False explicitly to opt
            # out (tests against plain-HTTP fakes don't need it at all).
            ca_cert = ca_path if os.path.exists(ca_path) else True
        self.ca_cert = ca_cert
        self.session = session or requests.Session()

    def _headers(self, content_type=None):
        h = {"Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if content_type:
            h["Content-Type"] = content_type
        return h

    def _request(self, method, path, params=None, body=None, content_type=None):
        url = self.base_url + path
        data = json.dumps(body) if body is not None else None
        resp = self.session.request(
            method,
            url,
            params=params,
            data=data,
            headers=self._headers(content_type or ("application/json" if body else None)),
            verify=self.ca_cert,
            timeout=30,
        )
        if resp.status_code >= 300:
            raise KubeError(resp.status_code, resp.text)
        return resp.json() if resp.text else {}

    # -- reads ---------------------------------------------------------------

    def list_nodes(self, label_selector=None):
        params = {}
        if label_selector:
            params["labelSelector"] = label_selector
        return self._request("GET", "/api/v1/nodes", params=params).get("items", [])

    def list_pods(self, namespace=None, field_selector=None, label_selector=None):
        path = (
            f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"
        )
        params = {}
        if field_selector:
            params["fieldSelector"] = field_selector
        if label_selector:
            params["labelSelector"] = label_selector
        return self._request("GET", path, params=params).get("items", [])

    def get_pod(self, namespace, name):
        return self._request("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")

    # -- writes --------------------------------------------------------------

    def patch_node_labels(self, node_name, labels):
        """Strategic-merge patch of node labels (reference
        label-nodes-daemon.py:50-57)."""
        return self._request(
            "PATCH",
            f"/api/v1/nodes/{node_name}",
            body={"metadata": {"labels": labels}},
            content_type="application/strategic-merge-patch+json",
        )

    def get_node(self, name):
        return self._request("GET", f"/api/v1/nodes/{name}")

    def cordon_node(self, node_name, cordoned_by=None):
        """Mark a node unschedulable (kubectl cordon): the gang
        scheduler's node_ready_and_schedulable excludes it from every
        subsequent pass. The faults reactor cordons a node whose chip
        went Unhealthy before draining its gangs.

        ``cordoned_by`` additionally stamps CORDONED_BY_ANNOTATION so a
        RESTARTED controller can recognize (and later lift) its own
        cordons without ever touching an operator's manual one — plain
        ``spec.unschedulable`` carries no ownership."""
        body = {"spec": {"unschedulable": True}}
        if cordoned_by:
            body["metadata"] = {
                "annotations": {CORDONED_BY_ANNOTATION: cordoned_by}
            }
        return self._request(
            "PATCH",
            f"/api/v1/nodes/{node_name}",
            body=body,
            content_type="application/merge-patch+json",
        )

    def uncordon_node(self, node_name, clear_cordoned_by=True):
        """Reverse of cordon_node (kubectl uncordon); also clears the
        ownership annotation so a stale marker can't claim a future
        manual cordon."""
        body = {"spec": {"unschedulable": False}}
        if clear_cordoned_by:
            # JSON merge patch: null deletes the annotation key.
            body["metadata"] = {
                "annotations": {CORDONED_BY_ANNOTATION: None}
            }
        return self._request(
            "PATCH",
            f"/api/v1/nodes/{node_name}",
            body=body,
            content_type="application/merge-patch+json",
        )

    def patch_pod(self, namespace, name, patch,
                  content_type="application/strategic-merge-patch+json"):
        return self._request(
            "PATCH",
            f"/api/v1/namespaces/{namespace}/pods/{name}",
            body=patch,
            content_type=content_type,
        )

    def create_pod(self, namespace, pod):
        return self._request(
            "POST", f"/api/v1/namespaces/{namespace}/pods", body=pod
        )

    def delete_pod(self, namespace, name, uid=None, grace_seconds=None):
        """Delete a pod (gang-bind compensation: the owning controller
        recreates it and the gang re-forms with consistent ranks).

        Pass ``uid`` to precondition the delete so a compensation racing
        the controller's recreate can never kill the fresh replacement.
        ``grace_seconds=0`` force-deletes (the object disappears
        immediately instead of lingering in Terminating)."""
        body = {}
        if uid:
            body["preconditions"] = {"uid": uid}
        if grace_seconds is not None:
            body["gracePeriodSeconds"] = grace_seconds
        return self._request(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}",
            body=body or None,
        )

    def bind_gated_pod(self, namespace, name, node_name, gate_name,
                       extra_env=None):
        """Pin a scheduling-gated pod to a node and lift the gate.

        While a pod is gated, Kubernetes permits tightening nodeSelector; we
        set kubernetes.io/hostname then remove our gate so the default
        scheduler places it (no delete/recreate, unlike the reference's
        replace-with-nodeAffinity at schedule-daemon.py:447-497).

        The patch MUST be a JSON merge patch: schedulingGates has
        patchStrategy=merge/mergeKey=name, so a strategic-merge patch that
        omits a gate would silently keep it; merge-patch replaces the list
        wholesale, actually deleting the gate.
        """
        pod = self.get_pod(namespace, name)
        gates = [
            g
            for g in pod["spec"].get("schedulingGates", [])
            if g.get("name") != gate_name
        ]
        selector = dict(pod["spec"].get("nodeSelector", {}))
        selector["kubernetes.io/hostname"] = node_name
        patch = {
            "spec": {"nodeSelector": selector, "schedulingGates": gates}
        }
        if extra_env:
            # Surface gang rank facts as annotations (env cannot be mutated
            # post-creation; the workload reads the downward API).
            patch["metadata"] = {"annotations": extra_env}
        return self.patch_pod(
            namespace, name, patch,
            content_type="application/merge-patch+json",
        )

    def unbind_pod(self, namespace, name, gate_name, clear_annotations=(),
                   expect_uid=None, deadline=None):
        """Reverse of bind_gated_pod: restore the scheduling gate, drop
        the hostname pin and the gang annotations.

        When the gate is still present (the bind PATCH never landed) this
        is accepted everywhere — the gate set shrinks or stays equal, and
        the patch just cleans up. When the gate is actually gone, every
        conformant API server ≥1.27 rejects it with 422: pod
        scheduling-readiness validation only permits REMOVING gates on
        update. So for truly-bound pods this call is a cheap probe whose
        422 routes the caller to recreate_gated_pod — the real lossless
        path on production clusters.

        ``expect_uid`` guards against the name having been taken over by
        an unrelated replacement pod since the caller observed it: on
        mismatch a KubeError(404) is raised (the pod we meant is gone),
        mirroring the uid-preconditioned delete.

        The PATCH carries the GET's resourceVersion as an
        optimistic-concurrency precondition: without it, a same-name
        replacement created between the GET and the PATCH would be
        re-gated/annotated despite the uid check (which only covers the
        GET moment). A 409 from a conformant server means some writer
        moved the object meanwhile — usually a benign concurrent write
        (controller stamping an annotation, a status update), so the
        GET+PATCH is retried a few times with a short backoff; the
        re-GET's uid check catches the actual-replacement case as 404
        (when ``expect_uid`` wasn't passed, the FIRST GET's uid becomes
        the pin, so a retry can never re-gate a same-name replacement).
        Persistent conflict surfaces as the final 409.

        Retries back off with jitter under a hard monotonic ``deadline``
        (default ``UNBIND_DEADLINE_S`` from now): conflict-retry storms
        synchronized across daemon replicas after an apiserver recovery
        would otherwise re-herd on fixed offsets, and a busy object must
        not stall the caller's compensation pass indefinitely.
        """
        if deadline is None:
            deadline = time.monotonic() + UNBIND_DEADLINE_S
        last_err = None
        for attempt in range(4):
            if attempt and not backoff_sleep(
                attempt - 1, 0.1, 1.0, deadline=deadline
            ):
                break  # deadline passed: surface the last conflict
            pod = self.get_pod(namespace, name)
            uid_now = pod.get("metadata", {}).get("uid")
            if expect_uid and uid_now != expect_uid:
                raise KubeError(
                    404, f"pod {namespace}/{name} uid changed "
                         f"(expected {expect_uid}); not touching replacement"
                )
            if not expect_uid:
                expect_uid = uid_now
            gates = list(pod["spec"].get("schedulingGates") or [])
            if not any(g.get("name") == gate_name for g in gates):
                gates.append({"name": gate_name})
            patch = {
                "spec": {
                    "schedulingGates": gates,
                    # JSON merge patch: null deletes just this key.
                    "nodeSelector": {"kubernetes.io/hostname": None},
                },
                "metadata": {
                    "resourceVersion": pod.get("metadata", {}).get(
                        "resourceVersion"
                    ),
                },
            }
            if clear_annotations:
                patch["metadata"]["annotations"] = {
                    k: None for k in clear_annotations
                }
            try:
                return self.patch_pod(
                    namespace, name, patch,
                    content_type="application/merge-patch+json",
                )
            except KubeError as err:
                if err.status != 409:
                    raise
                last_err = err
        raise last_err

    def recreate_gated_pod(self, namespace, name, gate_name,
                           clear_annotations=(), expect_uid=None,
                           deadline=None):
        """Delete + create the pod from its live manifest with the gate
        restored and the bind mutations stripped.

        The fallback when unbind_pod is rejected (strict servers forbid
        re-adding schedulingGates): equivalent in effect for bare pods —
        same name/spec, fresh uid — and exactly the reference scheduler's
        own bind mechanism in reverse (it binds by delete+recreate,
        schedule-daemon.py:447-497). The delete is uid-preconditioned so
        racing an external recreate can never destroy a fresh pod, and
        force (grace 0) so the name frees immediately instead of
        lingering in Terminating under the create.

        Delete-then-create cannot be atomic (same name). The create is
        retried on 409 AlreadyExists (graceful-termination tail) and
        transient 5xx; if every retry fails the full manifest is logged
        at ERROR so an operator can restore the pod by hand — strictly
        better than the silent loss a plain delete would be.

        ``deadline`` (time.monotonic value) caps the retry loop; the
        caller compensating a whole gang shares ONE deadline across
        members so a stuck finalizer on a large gang cannot stall the
        single-threaded scheduling pass for minutes (default: 10s from
        now for a standalone call)."""
        pod = self.get_pod(namespace, name)
        uid = pod.get("metadata", {}).get("uid")
        if expect_uid and uid != expect_uid:
            raise KubeError(
                404, f"pod {namespace}/{name} uid changed "
                     f"(expected {expect_uid}); not touching replacement"
            )
        meta = pod.get("metadata", {})
        # ownerReferences/finalizers must survive the recreate: pods routed
        # here can carry GC-only (controller: false) owner refs, and
        # dropping them would orphan the pod from its parent's deletion.
        fresh_meta = {
            k: v
            for k, v in meta.items()
            if k in ("name", "namespace", "labels", "annotations",
                     "ownerReferences", "finalizers")
        }
        annotations = {
            k: v
            for k, v in (fresh_meta.get("annotations") or {}).items()
            if k not in clear_annotations
        }
        if annotations:
            fresh_meta["annotations"] = annotations
        else:
            fresh_meta.pop("annotations", None)
        spec = dict(pod.get("spec", {}))
        spec.pop("nodeName", None)
        selector = {
            k: v
            for k, v in (spec.get("nodeSelector") or {}).items()
            if k != "kubernetes.io/hostname"
        }
        if selector:
            spec["nodeSelector"] = selector
        else:
            spec.pop("nodeSelector", None)
        gates = list(spec.get("schedulingGates") or [])
        if not any(g.get("name") == gate_name for g in gates):
            gates.append({"name": gate_name})
        spec["schedulingGates"] = gates
        fresh = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": fresh_meta,
            "spec": spec,
        }
        try:
            self.delete_pod(namespace, name, uid=uid, grace_seconds=0)
        except KubeError as err:
            if err.status == 409:
                # uid-preconditioned delete racing an external
                # delete+recreate: the name now belongs to a replacement
                # — our target is equally gone. Surface as 404 so the
                # caller's "gone" handling applies (same convention as
                # the uid-mismatch check above); a conformant server
                # reports a failed uid precondition as 409 Conflict.
                raise KubeError(
                    404, f"pod {namespace}/{name} replaced under us "
                         f"(uid precondition conflict)"
                ) from err
            if 400 <= err.status < 500:
                # Definite rejection (RBAC etc.): the pod was NOT
                # deleted, nothing is lost — surface it.
                raise
            # 5xx: indeterminate; fall through to the create loop (the
            # uid probe below sorts out what actually happened).
            log.warning("recreate delete of %s/%s got %s; continuing",
                        namespace, name, err)
        except requests.RequestException as err:
            # Response lost — the delete may have landed. Continue into
            # the create loop so a landed delete still gets its create;
            # if nothing succeeds the manifest is logged below.
            log.warning("recreate delete of %s/%s network error %s; "
                        "continuing", namespace, name, err)
        # Create retry loop. Two slow-but-fine states to ride out:
        #   * the old object lingers under a finalizer (grace-0 delete
        #     sets deletionTimestamp but the name stays taken until the
        #     finalizer manager releases it) → 409 until it clears;
        #   * our own create landed but the response was lost → 409 from
        #     the FRESH pod; the uid probe below detects it as success.
        # The deadline bounds how long one member can stall the
        # single-threaded scheduling pass (a stuck finalizer past it is
        # an operator problem; the manifest log below covers restore).
        last_err = None
        if deadline is None:
            deadline = time.monotonic() + 10.0
        attempt = 0
        while True:
            try:
                return self.create_pod(namespace, fresh)
            except KubeError as err:
                last_err = err
                if not (err.status == 409 or err.status >= 500):
                    break  # definite rejection; retrying can't help
            except requests.RequestException as err:
                # Network-level failure AFTER the delete landed: must not
                # escape without the manifest log below.
                last_err = err
            try:
                cur = self.get_pod(namespace, name)
                cur_meta = cur.get("metadata", {})
                cur_gates = {
                    g.get("name")
                    for g in cur.get("spec", {}).get("schedulingGates") or []
                }
                if (
                    cur_meta.get("uid")
                    and cur_meta.get("uid") != uid
                    and not cur_meta.get("deletionTimestamp")
                    and gate_name in cur_gates
                ):
                    # Fresh uid AND carrying our restored gate: this is
                    # the pod we POSTed — the create landed, its
                    # response was lost. A same-name pod created
                    # externally would not carry the gate; that case
                    # falls through to the deadline + manifest log.
                    return cur  # our create landed; response was lost
                if (
                    cur_meta.get("uid") == uid
                    and not cur_meta.get("deletionTimestamp")
                ):
                    # The ORIGINAL delete never landed (lost request):
                    # re-issue it, still uid-preconditioned, so the
                    # create can ever succeed.
                    try:
                        self.delete_pod(
                            namespace, name, uid=uid, grace_seconds=0
                        )
                    except (KubeError, requests.RequestException):
                        pass  # next loop iteration probes again
            except (KubeError, requests.RequestException):
                pass  # 404 = name just freed; else keep retrying
            if not backoff_sleep(attempt, 0.25, 2.0, deadline=deadline):
                break
            attempt += 1
        log.error(
            "recreate of %s/%s failed after retries (%s); manifest for "
            "manual restore: %s", namespace, name, last_err,
            json.dumps(fresh),
        )
        raise last_err
