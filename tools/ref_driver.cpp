// Headless driver for the reference CPU path tracer (/root/reference).
//
// The reference's own binary requires SDL/GL for its preview; this driver
// links only the scene parser and the cpu estimator (Raytracer/Shader/BSDF/
// Light/Random) so we can (a) dump *linear float* radiance for allclose
// comparisons against the JAX renderer and (b) measure the reference's
// samples/s for BASELINE.md. The pixel loop mirrors cpu/Renderer.cpp:25-81:
// stratified floor(sqrt(spp))^2 jittered samples, divide by spp (the 25/32
// quirk), per-slice RNG seed 0715517*(yOffset+1), sy flipped via (H - y).
//
// Usage: ref_driver SCENE.json W H SPP PASSES OUT.raw [THREADS]
//   OUT.raw = float32 RGBA, row-major, H*W*4, linear radiance (total/passes)

#include "scene/Parser.h"
#include "scene/Scene.h"
#include "renderer/cpu/Scene.h"
#include "renderer/cpu/Raytracer.h"
#include "renderer/cpu/Shader.h"
#include "renderer/cpu/Random.h"
#include "renderer/cpu/Ray.h"
#include "renderer/cpu/SurfacePoint.h"

#include <glm/glm.hpp>
#include <glm/gtc/matrix_transform.hpp>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <future>
#include <memory>
#include <vector>

int main(int argc, char** argv)
{
    if (argc < 7) {
        fprintf(stderr, "usage: %s SCENE.json W H SPP PASSES OUT.raw [THREADS]\n", argv[0]);
        return 1;
    }
    const char* scenePath = argv[1];
    int width = atoi(argv[2]);
    int height = atoi(argv[3]);
    int spp = atoi(argv[4]);
    int passes = atoi(argv[5]);
    const char* outPath = argv[6];
    int threads = argc > 7 ? atoi(argv[7]) : (int)std::thread::hardware_concurrency();

    scene::Scene sceneData;
    if (!scene::Parser::load(sceneData, scenePath, (float)width / height)) {
        fprintf(stderr, "failed to load %s\n", scenePath);
        return 1;
    }

    cpu::Scene scene(sceneData);
    cpu::Raytracer raytracer(&scene);
    cpu::Shader shader(&scene, &raytracer);

    const cpu::Camera& camera = scene.camera;
    const glm::vec4 viewport(0, 0, 1, 1);
    glm::vec3 p1 = glm::unProject(glm::vec3(0.f, 0.f, 0.f), camera.transform, camera.projection, viewport);
    glm::vec3 p2 = glm::unProject(glm::vec3(1.f, 0.f, 0.f), camera.transform, camera.projection, viewport);
    glm::vec3 p3 = glm::unProject(glm::vec3(0.f, 1.f, 0.f), camera.transform, camera.projection, viewport);
    glm::vec3 origin(glm::inverse(camera.transform) * glm::vec4(0.f, 0.f, 0.f, 1.f));

    std::vector<glm::vec4> radianceMap((size_t)width * height, glm::vec4(0));

    int samplesPerAxis = (int)sqrtf((float)spp);
    float pixelWidth = 1.f / width;
    float pixelHeight = 1.f / height;
    float sampleWidth = pixelWidth / samplesPerAxis;
    float sampleHeight = pixelHeight / samplesPerAxis;

    auto renderRows = [&](int y0, int y1) {
        cpu::Random random(0715517 * (y0 + 1));
        for (int pass = 1; pass <= passes; pass++) {
            for (int y = y0; y < y1; y++) {
                for (int x = 0; x < width; x++) {
                    glm::vec4 radiance(0);
                    for (int sy = 0; sy < samplesPerAxis; sy++) {
                        for (int sx = 0; sx < samplesPerAxis; sx++) {
                            glm::vec4 offset = random.generate() * .5f + glm::vec4(.5f);
                            float fx = x * pixelWidth + sx * sampleWidth + offset.x * sampleWidth;
                            float fy = (height - y) * pixelHeight + sy * sampleHeight + offset.y * sampleHeight;
                            glm::vec3 direction = glm::normalize(p1 + (p2 - p1) * fx + (p3 - p1) * fy - origin);
                            cpu::Ray ray;
                            ray.origin = origin;
                            ray.direction = direction;
                            cpu::SurfacePoint sp = raytracer.trace(ray);
                            radiance += shader.shade(sp, random);
                        }
                    }
                    radianceMap[(size_t)y * width + x] += radiance / (float)spp;
                }
            }
        }
    };

    auto start = std::chrono::steady_clock::now();
    std::vector<std::future<void>> tasks;
    int slice = (height + threads - 1) / threads;
    for (int y0 = 0; y0 < height; y0 += slice)
        tasks.push_back(std::async(std::launch::async, renderRows, y0, std::min(y0 + slice, height)));
    for (auto& t : tasks) t.wait();
    auto end = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(end - start).count();

    long long samples = (long long)width * height * samplesPerAxis * samplesPerAxis * passes;
    fprintf(stderr, "{\"samples\": %lld, \"seconds\": %.3f, \"samples_per_s\": %.0f, \"threads\": %d}\n",
            samples, secs, samples / secs, threads);

    for (auto& v : radianceMap) v /= (float)passes;
    FILE* f = fopen(outPath, "wb");
    fwrite(radianceMap.data(), sizeof(glm::vec4), radianceMap.size(), f);
    fclose(f);
    return 0;
}
